"""RBF-ARD kernel with variational log-hyperparameters (forward only).

Counterpart of ``vargp_tpu/kernels/rbf.py``.  theta = (log lengthscales
[D], log scale); q(theta) = N(log_mean, diag exp(log_logvar)).  The noise
of the reparameterised hyper samples is an argument, so a caller can feed
the same draws to this package and to the JAX one.
"""

from typing import NamedTuple

import torch

from vargp_tpu_torch.gpmath.mvn import diag_normal_kl
from vargp_tpu_torch.ops.cuda.cross_gram import cross_gram as _cross_gram_kernel
from vargp_tpu_torch.ops.cuda.sym_gram import sym_gram as _sym_gram_kernel
from vargp_tpu_torch.ops.device import resolve_device


class RBFParams(NamedTuple):
    """Variational posterior over log-hyperparameters."""

    log_mean: torch.Tensor  # (D + 1,)
    log_logvar: torch.Tensor  # (D + 1,)


class RBFPrior(NamedTuple):
    """Frozen prior over log-hyperparameters (chained across tasks)."""

    log_mean: torch.Tensor  # (D + 1,)
    log_logvar: torch.Tensor  # (D + 1,)


def default_prior(in_size: int, device: torch.device | str | None = None) -> RBFPrior:
    """Standard-normal prior over the log-hypers, on ``device`` (None means
    the card)."""
    z = torch.zeros(in_size + 1, device=resolve_device(device))
    return RBFPrior(log_mean=z, log_logvar=z.clone())


def sample_hypers(params: RBFParams, eps: torch.Tensor, *,
                  map_est: bool = False) -> torch.Tensor:
    """theta = log_mean + exp(log_logvar / 2) * eps, eps (n_hypers, D+1).
    With map_est the point estimate log_mean is the single sample."""
    if map_est:
        return params.log_mean[None, :]
    return params.log_mean + torch.exp(0.5 * params.log_logvar) * eps


def kl_hypers(params: RBFParams, prior: RBFPrior, *, map_est: bool = False) -> torch.Tensor:
    """KL(q(theta) || p(theta)) summed over dims; 0 under MAP."""
    if map_est:
        return params.log_mean.new_zeros(())
    return torch.sum(
        diag_normal_kl(params.log_mean, params.log_logvar, prior.log_mean, prior.log_logvar)
    )


def sym_gram(theta: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """K(z, z) for class-stacked z (O, M, D): (n_hypers, O, M, M), through
    K1.  The triangle-skip twin (K2, chosen at M >= 512 on the TPU) is not
    ported yet."""
    invs = torch.exp(-theta[:, :-1]).contiguous()  # (H, D)
    gamma2 = torch.exp(2.0 * theta[:, -1]).contiguous()  # (H,)
    return _sym_gram_kernel(z, invs, gamma2)


def cross_gram(theta: torch.Tensor, z: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K(z, x) for class-stacked z (O, M, D) against a batch x (B, D) shared
    by every class: (n_hypers, O, M, B), through K4 in full f32."""
    invs2 = torch.exp(-2.0 * theta[:, :-1]).contiguous()  # (H, D)
    gamma2 = torch.exp(2.0 * theta[:, -1]).contiguous()  # (H,)
    return _cross_gram_kernel(z, x, invs2, gamma2)


def gram_diag(theta: torch.Tensor) -> torch.Tensor:
    """Diagonal of k(x, x) = gamma^2, shaped (n_hypers, 1, 1)."""
    return torch.exp(2.0 * theta[:, -1])[:, None, None]
