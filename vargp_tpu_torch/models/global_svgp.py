"""The global continual SVGP ("VAR-GP (Global)" ablation): the ELBO
pieces, the predictive probabilities and the construction of a task's
parameters.

Counterpart of ``vargp_tpu/models/global_svgp.py``.  One global inducing
set per class, grown per task by the caller, and the streaming-SVGP
correction

  u_prev_reg = E_{u ~ q_t(u_{t-1} | theta)}[log q_{t-1}(u) - log p_{t-1}(u)],

with ELBO beta*kl_hypers + kl_u - u_prev_reg + (N/B)*nll.  Every random
draw is an explicit tensor in ``noise``:

  ``hyper_eps`` (n_var_samples, D+1)         hyper-sample noise
  ``lik_eps``   (H, n_f, O, B)               function-sample noise
  ``reg_eps``   (n_var_samples, H, O, M_prev) the regulariser's draws of
                                             u_{t-1} (``loss`` with prev only)

The regulariser's samples keep their gradient, as in the JAX package: no
stop-gradient on ``reg_eps``'s path.

Kernels: ``kernels.rbf.gram`` reaches K5 and ``gpmath.cholesky`` K7.
The JAX ``loss`` computes K_zz twice when a previous task is given (in
``forward`` and again in ``_whiten(full_cov=True)``), with K(z, prev.z)
and K(prev.z, prev.z) as two more Grams.  Here one self-Gram of the rows
[z; prev.z] (K5's symmetric launch) gives all three as its blocks, and
the forward's factor of K_zz serves the regulariser too: the same values
to rounding and, through autograd, the same gradient.  One Gram also
rounds alike the entries of rows that z and prev.z share (all of prev.z
at a task's first step, nearly so after), which the f32 cancellation in
K(prev.z, prev.z) - W^T W needs: from separate products, whose rounding
differs with their shapes, the regulariser parts from the JAX package's
by 1e-5 relative at the parity tests' sizes.  A step therefore launches
K5 twice (the symmetric K_zz, or the joint Gram with a previous task,
and the cross K_zx against the batch) and K7 once at task 0, three times
with a previous task (K_zz, K(prev.z, prev.z) and the predictive
covariance).  K7 reads only the lower triangle where ``jnp.linalg.cholesky``
symmetrises its input, so every matrix is symmetrised before K7
(``gpmath.sym_cholesky``), as the JAX call does: the predictive covariance
Kxx - W^T W + C^T C is symmetric only to rounding (and near 0 when z
equals prev.z), and so are the Grams' plain versions on the CPU (K5's
symmetric launch is bitwise symmetric: there it changes nothing).
"""

from dataclasses import dataclass
from typing import NamedTuple

import torch

from vargp_tpu_torch import gpmath
from vargp_tpu_torch.kernels import (
    RBFParams,
    RBFPrior,
    default_prior,
    gram,
    gram_diag,
    init_rbf,
    kl_hypers,
    sample_hypers,
)
from vargp_tpu_torch.likelihoods import softmax_loss, softmax_predict
from vargp_tpu_torch.models.vargp import eval_budget_cfg, select_inducing
from vargp_tpu_torch.ops.device import check_on_device, resolve_device
from vargp_tpu_torch.train.optim import tree_leaves


class GlobalPrev(NamedTuple):
    """The previous task's frozen variational state."""

    z: torch.Tensor  # (O, M_prev, D)
    u_mean: torch.Tensor  # (O, M_prev, 1)
    u_tril: torch.Tensor  # (O, M_prev, M_prev)


class GlobalSVGPParams(NamedTuple):
    """Parameters of the current task, in the JAX package's field order
    (its checkpoints load with no remapping)."""

    z: torch.Tensor  # (O, M, D)
    u_mean: torch.Tensor  # (O, M, 1)
    u_tril_vec: torch.Tensor  # (O, M(M+1)/2), row-major packing
    kernel: RBFParams


@dataclass(frozen=True)
class GlobalSVGPConfig:
    M: int
    out_size: int
    in_size: int
    n_f: int = 10
    n_var_samples: int = 3
    map_est_hypers: bool = False
    jitter: float = gpmath.DEFAULT_JITTER


def _whiten(L, Kzx, u_mean, u_tril, Kxx=None, jitter=gpmath.DEFAULT_JITTER):
    """The SVGP conditional against the inducing factor L = chol(K_zz):

      mu  = Kxz Kzz^{-1} u_mean,
      cov = Kxx - Kxz Kzz^{-1} Kzx + Kxz Kzz^{-1} S Kzz^{-1} Kzx

    through one triangular solve of [u_mean | u_tril | K_zx].  Returns
    (mu, diag(Kxz Kzz^{-1} Kzx), diag(C^T C)), or given Kxx
    (mu, cov, chol(Kxx))."""
    M = L.shape[-1]
    batch = L.shape[:-2]
    rhs = torch.cat([
        torch.broadcast_to(u_mean, (*batch, *u_mean.shape[-2:])),
        torch.broadcast_to(u_tril, (*batch, *u_tril.shape[-2:])),
        Kzx,
    ], dim=-1)
    sol = gpmath.tri_solve(L, rhs)
    Lm, LLS, W = sol[..., :1], sol[..., 1:1 + M], sol[..., 1 + M:]
    mu = torch.einsum("...mi,...mb->...b", Lm, W)
    C = torch.einsum("...mi,...mb->...ib", LLS, W)
    if Kxx is not None:
        cov = Kxx - torch.einsum("...mb,...mc->...bc", W, W) + torch.einsum(
            "...ib,...ic->...bc", C, C)
        return mu, cov, gpmath.sym_cholesky(Kxx, jitter)
    return mu, torch.sum(torch.square(W), dim=-2), torch.sum(torch.square(C), dim=-2)


def _check_noise(noise: dict, cfg: GlobalSVGPConfig, B: int, M_prev: int | None):
    H = 1 if cfg.map_est_hypers else cfg.n_var_samples
    want = {
        "hyper_eps": (cfg.n_var_samples, cfg.in_size + 1),
        "lik_eps": (H, cfg.n_f, cfg.out_size, B),
    }
    if M_prev is not None:
        want["reg_eps"] = (cfg.n_var_samples, H, cfg.out_size, M_prev)
    for key, shape in want.items():
        got = noise.get(key)
        if got is None or tuple(got.shape) != shape:
            raise ValueError(
                f"noise[{key!r}]: expected shape {shape}, got "
                f"{None if got is None else tuple(got.shape)}"
            )


def forward(params: GlobalSVGPParams, x: torch.Tensor, hyper_eps: torch.Tensor,
            cfg: GlobalSVGPConfig, prev_z: torch.Tensor | None = None):
    """Diagonal predictive marginals (mu, var), each (H, O, B), and the
    statistics the loss reads: u_tril, the inducing factor Lkuu, theta and
    K, the self-Gram of z, or of [z; prev_z] when ``prev_z`` is given.
    The variance is clamped at 0: the inducing points are training rows,
    so x == z occurs exactly and rounding can take the ~0 conditional
    variance below 0."""
    theta = sample_hypers(params.kernel, hyper_eps, map_est=cfg.map_est_hypers)
    u_tril = gpmath.vec2tril(params.u_tril_vec, cfg.M)
    rows = params.z if prev_z is None else torch.cat([params.z, prev_z], dim=-2)
    K = gram(theta, rows)  # K5's symmetric launch
    L = gpmath.sym_cholesky(K[..., :cfg.M, :cfg.M], cfg.jitter)  # K7
    Kzx = gram(theta, params.z, x.expand(cfg.out_size, *x.shape))  # K5's cross launch
    mu, diag1, diag2 = _whiten(L, Kzx, params.u_mean, u_tril)
    var = torch.clamp(gram_diag(theta) - diag1 + diag2, min=0.0)
    return mu, var, dict(u_tril=u_tril, Lkuu=L, theta=theta, K=K)


def _tensors(params, prev, *more):
    out = tree_leaves(params) + tree_leaves(prev)
    out.extend(t for t in more if isinstance(t, torch.Tensor))
    return out


def loss(params: GlobalSVGPParams, prev: GlobalPrev | None, prior: RBFPrior,
         x: torch.Tensor, y: torch.Tensor, noise: dict, cfg: GlobalSVGPConfig,
         weights: torch.Tensor | None = None, *, device=None):
    """ELBO pieces (kl_hypers, kl_u, u_prev_reg, nll); a trainer combines
    them as beta*kl_hypers + kl_u - u_prev_reg + (N/B)*nll.  ``weights``
    masks padded batch rows.  ``device=None`` means the card; every tensor
    must lie on it."""
    dev = resolve_device(device)
    check_on_device(dev, *_tensors(params, prev, *prior, x, y, weights, *noise.values()))
    _check_noise(noise, cfg, x.shape[0], None if prev is None else prev.z.shape[-2])
    mu, var, stats = forward(params, x, noise["hyper_eps"], cfg,
                             None if prev is None else prev.z)
    nll = softmax_loss(mu, var, y, noise["lik_eps"], weights=weights)
    klh = kl_hypers(params.kernel, prior, map_est=cfg.map_est_hypers)
    u_mean = params.u_mean[..., 0]
    kl = gpmath.mvn_kl(u_mean, stats["u_tril"], torch.zeros_like(u_mean), stats["Lkuu"])  # (H, O)
    kl_u = torch.mean(torch.sum(kl, dim=-1))
    u_prev_reg = mu.new_zeros(())
    if prev is not None:
        # q_t's density over the previous inducing values, full covariance
        M, K = cfg.M, stats["K"]
        pred_mu, pred_cov, Lkff_prev = _whiten(stats["Lkuu"], K[..., :M, M:], params.u_mean,
                                               stats["u_tril"], K[..., M:, M:], cfg.jitter)
        pred_L = gpmath.sym_cholesky(pred_cov, cfg.jitter)
        u = gpmath.mvn_sample(pred_mu, pred_L, noise["reg_eps"])  # (n_v, H, O, M_prev)
        log_q = gpmath.mvn_log_prob(u, prev.u_mean[..., 0], prev.u_tril)
        log_p = gpmath.mvn_log_prob(u, torch.zeros_like(pred_mu), Lkff_prev)
        u_prev_reg = torch.mean(torch.sum(log_q - log_p, dim=-1))
    return klh, kl_u, u_prev_reg, nll


def predict(params: GlobalSVGPParams, prev: GlobalPrev | None, x: torch.Tensor, noise: dict,
            cfg: GlobalSVGPConfig, *, n_f: int | None = None,
            n_var_samples: int | None = None, device=None) -> torch.Tensor:
    """Predictive class probabilities (B, out_size) from the task's own
    posterior (``prev`` is not read: the global posterior is the model).
    The evaluation-time MC budgets may be overridden; ``noise`` (hyper_eps,
    lik_eps) must match them."""
    dev = resolve_device(device)
    check_on_device(dev, *_tensors(params, prev, x, *noise.values()))
    cfg = eval_budget_cfg(cfg, n_f=n_f, n_var_samples=n_var_samples)
    _check_noise(noise, cfg, x.shape[0], None)
    mu, var, _ = forward(params, x, noise["hyper_eps"], cfg)
    return softmax_predict(mu, var, noise["lik_eps"])


def init_params(kernel_eps: torch.Tensor, u_eps: torch.Tensor, z_init: torch.Tensor,
                cfg: GlobalSVGPConfig, *, kernel_prior_from: RBFParams | None = None
                ) -> tuple[GlobalSVGPParams, RBFPrior]:
    """A new task's parameters and kernel prior from the standard-normal
    draws kernel_eps (D+1,) and u_eps (O, M, 1): u_mean = 0.5 u_eps,
    u_tril_vec all ones (off-diagonal included, as the reference has it);
    the prior chains from ``kernel_prior_from`` when given, else N(0, I)."""
    kernel = init_rbf(kernel_eps)
    if kernel_prior_from is not None:
        prior = RBFPrior(kernel_prior_from.log_mean, kernel_prior_from.log_logvar)
    else:
        prior = default_prior(cfg.in_size, device=z_init.device)
    u_tril_vec = torch.ones((cfg.out_size, gpmath.tril_size(cfg.M)), device=z_init.device)
    return GlobalSVGPParams(z_init, 0.5 * u_eps, u_tril_vec, kernel), prior


def grow_inducing(gen: torch.Generator, prev_z: torch.Tensor, data: torch.Tensor, M_new: int,
                  out_size: int) -> torch.Tensor:
    """The previous inducing rows followed by M_new - M_prev random data
    rows per class (``select_inducing`` from ``gen``); with nothing to add,
    a fresh copy of prev_z (the result is trained, prev_z stays frozen)."""
    M_add = M_new - prev_z.shape[-2]
    if M_add <= 0:
        return prev_z.detach().clone()
    return torch.cat([prev_z.detach(), select_inducing(gen, data, M_add, out_size)], dim=-2)


def freeze_task(params: GlobalSVGPParams) -> GlobalPrev:
    """A trained task's frozen state: detached copies of z and u_mean and
    the unpacked u_tril."""
    return GlobalPrev(
        z=params.z.detach().clone(),
        u_mean=params.u_mean.detach().clone(),
        u_tril=gpmath.vec2tril(params.u_tril_vec.detach()),
    )
