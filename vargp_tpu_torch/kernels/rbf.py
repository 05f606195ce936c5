"""RBF-ARD kernel with variational log-hyperparameters.

Counterpart of ``vargp_tpu/kernels/rbf.py``.  theta = (log lengthscales
[D], log scale); q(theta) = N(log_mean, diag exp(log_logvar)).  The noise
of the reparameterised hyper samples (and of ``init_rbf``) is an argument,
so a caller can feed the same draws to this package and to the JAX one.

The two fused-scaling Grams are ``torch.autograd.Function``s with the JAX
package's hand backward rules (``_sym_gram_bwd``, ``_cross_gram_p_bwd``):
plain f32 products that reuse one large contraction for the inputs' and
the lengthscales' cotangents, and never differentiate through the
kernels.  The generic ``gram`` scales its inputs here and goes through
``ops.dispatch.rbf_gram`` (K5, with ``_rbf_gram_bwd``); the deep kernel
computes its Grams with it.
"""

import math
from typing import NamedTuple

import torch

from vargp_tpu_torch.gpmath.mvn import diag_normal_kl
from vargp_tpu_torch.ops.cuda.cross_gram import cross_gram as _cross_gram_kernel
from vargp_tpu_torch.ops.cuda.sym_gram import sym_gram as _sym_gram_kernel
from vargp_tpu_torch.ops.cuda.sym_gram_tri import sym_gram_tri as _sym_gram_tri_kernel
from vargp_tpu_torch.ops.device import resolve_device
from vargp_tpu_torch.ops.dispatch import rbf_gram

# The JAX package's shape gate (rbf_gram.py:518): the triangle-skip Gram
# from this many chain rows up, the whole-square one below.
_TRI_MIN_ROWS = 512


class RBFParams(NamedTuple):
    """Variational posterior over log-hyperparameters."""

    log_mean: torch.Tensor  # (D + 1,)
    log_logvar: torch.Tensor  # (D + 1,)


class RBFPrior(NamedTuple):
    """Frozen prior over log-hyperparameters (chained across tasks)."""

    log_mean: torch.Tensor  # (D + 1,)
    log_logvar: torch.Tensor  # (D + 1,)


def init_rbf(eps: torch.Tensor) -> RBFParams:
    """The reference's initialisation from a standard-normal draw eps
    (D+1,): log_mean = log(0.5) + 0.05 eps, log_logvar = -2."""
    return RBFParams(
        log_mean=math.log(0.5) + 0.05 * eps,
        log_logvar=torch.full_like(eps, -2.0),
    )


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


def _sym_gram_impl(z, invs, gamma2):
    """K2 from S >= 512 rows and K1 below, as the JAX package routes its
    Pallas kernels; on the card both run one design and give the same
    values.  Its fallback to unfused math when a whole (h, o) block
    overflows the TPU's VMEM (rbf_gram.py:508-516) has no counterpart here:
    both kernels hold one tile per block (K1 64 x 64, K2 128 x 128) at
    any S."""
    if z.shape[-2] >= _TRI_MIN_ROWS:
        return _sym_gram_tri_kernel(z, invs, gamma2)
    return _sym_gram_kernel(z, invs, gamma2)


class _SymGram(torch.autograd.Function):
    """Backward: ``_sym_gram_bwd`` (vargp_tpu/ops/pallas/rbf_gram.py:556).
    K and d2 are symmetric in (i, j), so everything depends on the
    d2-cotangent through S = -(W + W^T)/2, W = g K, and one product S z
    serves both the z and the lengthscale cotangents."""

    @staticmethod
    def forward(ctx, z, invs, gamma2):
        K = _sym_gram_impl(z, invs, gamma2)
        ctx.save_for_backward(z, invs, gamma2, K)
        return K

    @staticmethod
    def backward(ctx, g):
        z, invs, gamma2, K = ctx.saved_tensors
        W = g * K  # (H, O, M, M)
        S = -0.5 * (W + W.transpose(-1, -2))
        invs2 = invs * invs  # (H, D)
        SZ = torch.matmul(S, z)  # (H, O, M, D), the large product
        R = torch.sum(S, dim=-1)  # (H, O, M)
        A = torch.einsum("hd,hoi->oid", invs2, R)
        B = torch.einsum("hd,hoid->oid", invs2, SZ)
        dz = 2.0 * (z * A - B)
        t12 = torch.einsum("hoi,oid->hd", R, z * z)
        t3 = 0.5 * torch.einsum("hoid,oid->hd", SZ, z)
        d_invs = 2.0 * invs * (t12 - 2.0 * t3)
        d_gamma2 = torch.sum(W, dim=(1, 2, 3)) / torch.clamp(gamma2, min=1e-30)
        return dz, d_invs, d_gamma2


class _CrossGram(torch.autograd.Function):
    """Backward: ``_cross_gram_p_bwd`` (vargp_tpu/kernels/rbf.py:168).  x
    is data by contract: it gets no cotangent (None, the JAX rule's zeros)."""

    @staticmethod
    def forward(ctx, z, x, invs2, gamma2):
        K = _cross_gram_kernel(z, x, invs2, gamma2)
        ctx.save_for_backward(z, x, invs2, gamma2, K)
        return K

    @staticmethod
    def backward(ctx, g):
        z, x, invs2, gamma2, K = ctx.saved_tensors
        W = g * K  # (H, O, M, B)
        gd2 = -0.5 * W
        R = torch.sum(gd2, dim=-1)  # (H, O, M)
        C = torch.sum(gd2, dim=(1, 2))  # (H, B)
        xs = x[None] * invs2[:, None, :]  # (H, B, D)
        t_zz = 2.0 * z * torch.einsum("hoi,hd->oid", R, invs2)
        t_cross = -2.0 * torch.einsum("hoib,hbd->oid", gd2, xs)
        P = torch.einsum("hoib,oid->hbd", gd2, z)  # (H, B, D)
        d_invs2 = (
            torch.einsum("hoi,oid->hd", R, z * z)
            + torch.einsum("hb,bd->hd", C, x * x)
            - 2.0 * torch.einsum("hbd,bd->hd", P, x)
        )
        d_gamma2 = torch.sum(W, dim=(1, 2, 3)) / gamma2
        return t_zz + t_cross, None, d_invs2, d_gamma2


def _split_theta(theta: torch.Tensor, n_batch_dims: int):
    """theta (n_hypers, D+1) -> lengthscales sigma (n_hypers, 1.., D) and
    gamma2 (n_hypers, 1.., 1), with ``n_batch_dims`` unit axes so that both
    broadcast over that many batch axes."""
    shape = (theta.shape[0], *([1] * n_batch_dims))
    sigma = torch.exp(theta[:, :-1]).reshape(*shape, -1)
    gamma2 = torch.exp(2.0 * theta[:, -1]).reshape(*shape, 1)
    return sigma, gamma2


def gram(theta: torch.Tensor, x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    """Batched RBF Gram: x (..., M, D), y (..., N, D) with the same batch
    dims, or None for y = x.  Returns (n_hypers, ..., M, N), through K5 in
    f32; every input, y included, gets a gradient."""
    sigma, gamma2 = _split_theta(theta, x.dim() - 2)
    sx = x[None] / sigma[..., None, :]
    sy = sx if y is None else y[None] / sigma[..., None, :]
    return rbf_gram(sx, sy, gamma2[..., 0].expand(sx.shape[:-2]))


def sym_gram(theta: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """K(z, z) for class-stacked z (O, M, D): (n_hypers, O, M, M), through
    K1, or K2 from M >= 512."""
    invs = torch.exp(-theta[:, :-1]).contiguous()  # (H, D)
    gamma2 = torch.exp(2.0 * theta[:, -1]).contiguous()  # (H,)
    return _SymGram.apply(z.contiguous(), invs, gamma2)


def cross_gram(theta: torch.Tensor, z: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K(z, x) for class-stacked z (O, M, D) against a batch x (B, D) shared
    by every class: (n_hypers, O, M, B), through K4 in full f32.  No
    gradient flows to x."""
    invs2 = torch.exp(-2.0 * theta[:, :-1]).contiguous()  # (H, D)
    gamma2 = torch.exp(2.0 * theta[:, -1]).contiguous()  # (H,)
    return _CrossGram.apply(z.contiguous(), x.detach().contiguous(), invs2, gamma2)


def gram_diag(theta: torch.Tensor) -> torch.Tensor:
    """Diagonal of k(x, x) = gamma^2, shaped (n_hypers, 1, 1)."""
    return torch.exp(2.0 * theta[:, -1])[:, None, None]
