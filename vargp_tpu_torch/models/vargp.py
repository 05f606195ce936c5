"""VAR-GP: the ELBO pieces, the predictive probabilities and the
construction of a task's parameters.

Counterpart of ``vargp_tpu/models/vargp.py``, for the RBF-ARD kernel on
the inputs and for the deep kernel (``cfg.dkl``: the RBF kernel on the
features of an MLP, ``params.phi``, trained with the rest).  ``loss`` is
differentiable: its gradient runs through the hand rules of the Grams and
the factorisation and through autograd elsewhere.  Every random draw of
the path is an explicit tensor in ``noise``:

  ``hyper_eps``  (n_var_samples, P+1)        hyper-sample noise, P =
                                             ``_theta_size(cfg)``
  ``prefix_eps`` (n_var_samples, H, O, c)    prefix draws of u_{<t}, c = S - M
                                             (``loss`` with a chain only)
  ``lik_eps``    (H, n_f, O, B)              function-sample noise

``utils.convert`` builds these from numpy arrays, which is how the tests
feed the JAX package's own draws to this package.

Routes through the chain's factorisation, as in the JAX package:
``cfg.solve_via_inverse`` (default) factors K_zz with its inverse
(``ops.dispatch.chol_and_inv``: K3 plus products, or K6 under
``VARGP_TPU_CHOLINV=pallas``) and takes the whitened-factored posterior,
or the materialised one under ``VARGP_TPU_AR_FORM=materialized``;
``solve_via_inverse=False`` factors it alone (``gpmath.cholesky``, K7),
builds the materialised posterior and solves against the factor.

``predict`` keeps the last ``ChainPosterior`` it built and reuses it while
the tensors it was built from are the same unchanged objects (see
``predict``); ``clear_posterior_cache`` drops it.
"""

import os
import weakref
from dataclasses import dataclass, replace
from typing import NamedTuple, Sequence

import torch

from vargp_tpu_torch import gpmath
from vargp_tpu_torch.kernels import (
    MLPParams,
    RBFParams,
    RBFPrior,
    cross_gram,
    default_prior,
    gram,
    gram_diag,
    init_mlp,
    init_rbf,
    kl_hypers,
    mlp_apply,
    sample_hypers,
    sym_gram,
)
from vargp_tpu_torch.kernels.deep import DEFAULT_FEATURES
from vargp_tpu_torch.likelihoods import softmax_loss, softmax_predict
from vargp_tpu_torch.ops.device import check_on_device, resolve_device
from vargp_tpu_torch.ops.dispatch import _env_choice, chol_and_inv
from vargp_tpu_torch.train.optim import tree_leaves
from vargp_tpu_torch.utils import tracing


class TaskPosterior(NamedTuple):
    """Frozen variational posterior of a completed task."""

    z: torch.Tensor  # (O, M, D)
    u_mean: torch.Tensor  # (O, M, 1)
    u_tril: torch.Tensor  # (O, M, M)


class VARGPParams(NamedTuple):
    """Parameters of the current task."""

    z: torch.Tensor  # (O, M, D)
    u_mean: torch.Tensor  # (O, M, 1)
    u_tril_vec: torch.Tensor  # (O, M(M+1)/2), row-major packing
    kernel: RBFParams
    phi: MLPParams | None = None  # the deep kernel's feature map, under DKL only


@dataclass(frozen=True)
class VARGPConfig:
    """Static model configuration; the fields of the JAX package's config.
    Only the row-major packing of ``u_tril_vec`` is ported: another
    ``tril_layout`` raises ``NotImplementedError``."""

    M: int
    out_size: int
    in_size: int
    n_f: int = 10
    n_var_samples: int = 3
    ep_var_mean: bool = True
    map_est_hypers: bool = False
    dkl: bool = False
    jitter: float = gpmath.DEFAULT_JITTER
    solve_via_inverse: bool = True
    tril_layout: str = "rowmajor"


class ForwardResult(NamedTuple):
    f_mean: torch.Tensor  # (H, O, B)
    f_var: torch.Tensor  # (H, O, B)
    kl_hypers: torch.Tensor  # scalar
    kl_u: torch.Tensor  # scalar


class ChainPosterior(NamedTuple):
    """The x-independent state of one forward pass: hyper samples, the
    chain Gram's factor (and its inverse under ``solve_via_inverse``), and
    the posterior, whitened-factored (``w_blocks``, ``v_mean``) or
    materialised (``mean``, ``LS``)."""

    theta: torch.Tensor  # (H, P+1), P = _theta_size(cfg)
    L: torch.Tensor  # (H, O, S, S)
    L_inv: torch.Tensor | None  # (H, O, S, S)
    mean: torch.Tensor | None  # (H, O, S, 1)
    LS: torch.Tensor | None  # (H, O, S, S)
    z_all: torch.Tensor  # (O, S, D)
    u_tril_t: torch.Tensor  # (O, M, M)
    w_blocks: torch.Tensor | None = None  # (H, O, T, M, M)
    v_mean: torch.Tensor | None = None  # (H, O, S, 1)


# chain rows from which the materialised form takes the closed-form
# block-LDL build instead of the task fold (the JAX package's threshold)
_FAST_CHAIN_MIN_ROWS = 768


def _ar_form() -> str:
    """The AR posterior's form under ``solve_via_inverse``:
    ``VARGP_TPU_AR_FORM`` = ``factored`` (default) or ``materialized``,
    read at each call; an unknown value raises."""
    return _env_choice("VARGP_TPU_AR_FORM", ("factored", "materialized"), "factored")


def _check_supported(cfg: VARGPConfig) -> None:
    if cfg.tril_layout != "rowmajor":
        raise NotImplementedError(f"tril_layout={cfg.tril_layout!r} is not ported")


def _theta_size(cfg) -> int:
    """Inputs the RBF kernel sees: the MLP's features under DKL, else the
    data's (always the data's for a config with no ``dkl`` field, the
    global SVGP's)."""
    return DEFAULT_FEATURES if getattr(cfg, "dkl", False) else cfg.in_size


def eval_budget_cfg(cfg: VARGPConfig, n_f: int | None = None,
                    n_var_samples: int | None = None) -> VARGPConfig:
    """Config with the eval-time MC budgets overridden; None keeps the
    config's value and a non-positive budget raises."""
    for name, v in (("n_f", n_f), ("n_var_samples", n_var_samples)):
        if v is not None and v < 1:
            raise ValueError(f"{name}={v}: eval MC budget must be >= 1")
    if n_f is None and n_var_samples is None:
        return cfg
    return replace(
        cfg,
        n_f=cfg.n_f if n_f is None else n_f,
        n_var_samples=cfg.n_var_samples if n_var_samples is None else n_var_samples,
    )


def _unpack_u_tril(params: VARGPParams, cfg: VARGPConfig) -> torch.Tensor:
    return gpmath.vec2tril(params.u_tril_vec, cfg.M)


def _concat_chain(params: VARGPParams, prev: Sequence[TaskPosterior], cfg):
    """The chain's inducing points, means and scale factors in task order,
    current task last."""
    u_tril_t = _unpack_u_tril(params, cfg)
    z_all = torch.cat([p.z for p in prev] + [params.z], dim=-2)
    u_means = [p.u_mean for p in prev] + [params.u_mean]
    u_trils = [p.u_tril for p in prev] + [u_tril_t]
    return z_all, u_means, u_trils, u_tril_t


def pad_chain(prev: Sequence[TaskPosterior], cfg: VARGPConfig, t_max: int,
              *, device=None):
    """Pad the frozen chain to ``t_max - 1`` entries with inert dummies
    (z=0, u_mean=0, u_tril=I) on ``device`` (None means the card) and
    return (padded_prev, chain_mask).  With the Gram masking in
    ``build_posterior`` the result for the real prefix is exact."""
    n_prev = len(prev)
    if n_prev > t_max - 1:
        raise ValueError(f"chain of {n_prev} tasks does not fit t_max={t_max}")
    device = resolve_device(device)
    check_on_device(device, *(t for p in prev for t in p))
    O, M, D = cfg.out_size, cfg.M, cfg.in_size
    dummy = TaskPosterior(
        z=torch.zeros((O, M, D), device=device),
        u_mean=torch.zeros((O, M, 1), device=device),
        u_tril=torch.eye(M, device=device).expand(O, M, M),
    )
    padded = tuple(prev) + (dummy,) * (t_max - 1 - n_prev)
    mask = torch.tensor(
        [1.0] * n_prev + [0.0] * (t_max - 1 - n_prev), device=device
    )
    return padded, mask


def _row_mask(chain_mask: torch.Tensor, M: int) -> torch.Tensor:
    """Per-inducing-row mask over the whole chain, current task included."""
    return torch.cat([
        torch.repeat_interleave(chain_mask, M), chain_mask.new_ones(M)
    ])


def _features(phi: MLPParams, rows: torch.Tensor, kind: str) -> torch.Tensor:
    """The deep kernel's phi(rows) under a ``features`` span; the rows are
    counted in ``tracing.FEATURES[kind]``."""
    tracing.FEATURES[kind] += rows.numel() // rows.shape[-1]
    with tracing.span("features"):
        return mlp_apply(phi, rows)


def build_posterior(params: VARGPParams, prev: Sequence[TaskPosterior],
                    hyper_eps: torch.Tensor, cfg: VARGPConfig, *,
                    chain_mask: torch.Tensor | None = None) -> ChainPosterior:
    """Sample theta and build the AR joint posterior over the whole chain."""
    with tracing.span("posterior"):
        theta = sample_hypers(params.kernel, hyper_eps, map_est=cfg.map_est_hypers)
        z_all, u_means, u_trils, u_tril_t = _concat_chain(params, prev, cfg)
        if cfg.dkl:
            Kzz = gram(theta, _features(params.phi, z_all, "chain"))  # (H, O, S, S), K5
        else:
            Kzz = sym_gram(theta, z_all)  # (H, O, S, S), K1 or K2
        if chain_mask is not None:
            rm = _row_mask(chain_mask, cfg.M)
            Kzz = Kzz * (rm[:, None] * rm[None, :]) + torch.diag(1.0 - rm)
        form = _ar_form()
        if cfg.solve_via_inverse:
            L, L_inv = chol_and_inv(gpmath.add_jitter(Kzz, cfg.jitter))
        else:
            L, L_inv = gpmath.cholesky(Kzz, cfg.jitter), None
        equal_blocks = all(u.shape[-2] == cfg.M for u in u_means)
        # a chain of one task takes the factored products, which equal the JAX
        # package's materialised form at T = 1 (mean = u_mean, scale = u_tril)
        if L_inv is not None and equal_blocks and (len(u_means) == 1 or form == "factored"):
            fpost = gpmath.ar_joint_posterior_factored(L, L_inv, u_means, u_trils)
            return ChainPosterior(
                theta=theta, L=L, L_inv=L_inv, mean=None, LS=None, z_all=z_all,
                u_tril_t=u_tril_t, w_blocks=fpost.w, v_mean=fpost.v,
            )
        if L_inv is not None and z_all.shape[-2] >= _FAST_CHAIN_MIN_ROWS:
            post = gpmath.ar_joint_posterior_fast(L, L_inv, u_means, u_trils)
        else:
            post = gpmath.ar_joint_posterior(L, u_means, u_trils, L_inv=L_inv)
        return ChainPosterior(
            theta=theta, L=L, L_inv=L_inv, mean=post.mean, LS=post.LS, z_all=z_all,
            u_tril_t=u_tril_t,
        )


def marginal_diag(cp: ChainPosterior, params: VARGPParams, x: torch.Tensor,
                  cfg: VARGPConfig, *, chain_mask: torch.Tensor | None = None):
    """Diagonal predictive marginal (f_mean, f_var), each (H, O, B).  Under
    DKL, phi(x) is computed once and broadcast over the class heads (the
    JAX package applies phi to x broadcast to (O, B, D): the same values,
    and autograd sums the heads' cotangents alike)."""
    with tracing.span("marginal"):
        if cfg.dkl:
            fx = _features(params.phi, x, "batch")  # (B, P)
            fx = fx.expand(cfg.out_size, *fx.shape)
            fz = _features(params.phi, cp.z_all, "chain")
            Kzx = gram(cp.theta, fz, fx)  # (H, O, S, B), K5
        else:
            Kzx = cross_gram(cp.theta, cp.z_all, x)  # (H, O, S, B), K4
        if chain_mask is not None:
            Kzx = Kzx * _row_mask(chain_mask, cfg.M)[:, None]
        kxx_diag = gram_diag(cp.theta)
        if cp.w_blocks is not None:
            return gpmath.whitened_marginal_diag_factored(
                cp.L_inv, cp.v_mean, cp.w_blocks, Kzx, kxx_diag
            )
        return gpmath.whitened_marginal_diag(cp.L, cp.mean, cp.LS, Kzx, kxx_diag, L_inv=cp.L_inv)


def _check_noise(noise: dict, cfg: VARGPConfig, c: int, B: int, with_kl: bool):
    H = 1 if cfg.map_est_hypers else cfg.n_var_samples
    want = {
        "hyper_eps": (cfg.n_var_samples, _theta_size(cfg) + 1),
        "lik_eps": (H, cfg.n_f, cfg.out_size, B),
    }
    if with_kl and c:
        want["prefix_eps"] = (cfg.n_var_samples, H, cfg.out_size, c)
    for key, shape in want.items():
        got = noise.get(key)
        if got is None or tuple(got.shape) != shape:
            raise ValueError(
                f"noise[{key!r}]: expected shape {shape}, got "
                f"{None if got is None else tuple(got.shape)}"
            )


def _check_inputs(prev, x: torch.Tensor, noise: dict, cfg: VARGPConfig, with_kl: bool) -> int:
    """Refuse an unported config or noise of the wrong shapes; returns the
    chain's prefix rows c."""
    _check_supported(cfg)
    c = len(prev) * cfg.M
    _check_noise(noise, cfg, c, x.shape[0], with_kl)
    return c


def forward(params: VARGPParams, prev: Sequence[TaskPosterior],
            prior: RBFPrior | None, x: torch.Tensor, noise: dict,
            cfg: VARGPConfig, *, with_kl: bool,
            chain_mask: torch.Tensor | None = None) -> ForwardResult:
    """One ELBO forward pass: the diagonal predictive moments per hyper
    sample and, when ``with_kl``, the two KL terms."""
    c = _check_inputs(prev, x, noise, cfg, with_kl)
    cp = build_posterior(params, prev, noise["hyper_eps"], cfg, chain_mask=chain_mask)
    f_mean, f_var = marginal_diag(cp, params, x, cfg, chain_mask=chain_mask)
    if not with_kl:
        zero = f_mean.new_zeros(())
        return ForwardResult(f_mean, f_var, zero, zero)

    L, L_inv = cp.L, cp.L_inv
    klh = kl_hypers(params.kernel, prior, map_est=cfg.map_est_hypers)
    if prev:
        L21 = L[..., c:, :c]
        L22 = L[..., c:, c:]  # factor of the conditional prior covariance
        eps = noise["prefix_eps"]  # (n_v, H, O, c)
        # w = L11^{-1} u_{<t}, u_{<t} ~ q(u_{<t}|theta), so that the
        # conditional prior mean is L21 w
        if cp.w_blocks is not None:
            # drawn in whitened space: the prefix of the joint posterior is
            # (v[:c], blockdiag(w[:n_prev]))
            n_prev = c // cfg.M
            e4 = eps.reshape(*eps.shape[:-1], n_prev, cfg.M, 1)
            s = gpmath.mm(cp.w_blocks[..., :n_prev, :, :], e4)
            w = cp.v_mean[..., :c, :] + s.reshape(*eps.shape[:-1], c, 1)
        else:
            u_lt = gpmath.mvn_sample(cp.mean[..., :c, 0], cp.LS[..., :c, :c], eps)
            if L_inv is not None:
                w = gpmath.mm(L_inv[..., :c, :c], u_lt[..., None])
            else:
                w = gpmath.tri_solve(L[..., :c, :c], u_lt[..., None])
        prior_mu_t = gpmath.mm(L21, w)[..., 0]  # (n_v, H, O, M)
        mask = 1.0 if cfg.ep_var_mean else 0.0
        var_mu_t = prior_mu_t * mask + params.u_mean[..., 0]
        L22_inv = None if L_inv is None else L_inv[..., c:, c:]
        kl = gpmath.mvn_kl(var_mu_t, cp.u_tril_t, prior_mu_t, L22, Lp_inv=L22_inv)  # (n_v, H, O)
    else:
        mu = params.u_mean[..., 0]
        kl = gpmath.mvn_kl(mu, cp.u_tril_t, torch.zeros_like(mu), L, Lp_inv=L_inv)
    kl_u = torch.mean(torch.sum(kl, dim=-1))
    return ForwardResult(f_mean, f_var, klh, kl_u)


def _tensors(params, prev, *more):
    out = tree_leaves(params)
    for p in prev:
        out.extend(p)
    out.extend(t for t in more if isinstance(t, torch.Tensor))
    return out


def loss(params: VARGPParams, prev: Sequence[TaskPosterior], prior: RBFPrior,
         x: torch.Tensor, y: torch.Tensor, noise: dict, cfg: VARGPConfig,
         weights: torch.Tensor | None = None,
         chain_mask: torch.Tensor | None = None, *, device=None):
    """ELBO pieces (kl_hypers, kl_u, nll); a trainer combines them as
    beta*kl_hypers + kl_u + (N/B)*nll.  ``weights`` masks padded batch
    rows, ``chain_mask`` turns on padded-chain mode (``pad_chain``).
    ``device=None`` means the card; every tensor must lie on it."""
    dev = resolve_device(device)
    check_on_device(
        dev, *_tensors(params, prev, *prior, x, y, weights, chain_mask, *noise.values())
    )
    out = forward(params, prev, prior, x, noise, cfg, with_kl=True, chain_mask=chain_mask)
    with tracing.span("likelihood"):
        nll = softmax_loss(out.f_mean, out.f_var, y, noise["lik_eps"], weights=weights)
    return out.kl_hypers, out.kl_u, nll


def predict(params: VARGPParams, prev: Sequence[TaskPosterior], x: torch.Tensor,
            noise: dict, cfg: VARGPConfig, *, n_f: int | None = None,
            n_var_samples: int | None = None,
            chain_mask: torch.Tensor | None = None, device=None) -> torch.Tensor:
    """Predictive class probabilities (B, out_size).  The eval-time MC
    budgets may be overridden; ``noise`` must match them.

    The chain posterior depends on ``params``, ``prev``,
    ``noise["hyper_eps"]`` and ``chain_mask`` alone, not on ``x``, so a
    caller that passes the same noise for every batch of a split (the
    analysis does) shares one posterior among the batches: ``predict``
    keeps the last one it built and reuses it while every tensor it was
    built from is the same object at the same ``_version``, under the same
    evaluation config, device, route knobs and float32 matmul precision.
    Reused or built anew, the probabilities are bitwise the same.  The
    ``posterior`` span opens only around a build;
    ``utils.tracing.POSTERIOR`` counts each call's ``build`` or ``reuse``.
    A write that bypasses the version counter (through ``.data`` or a
    numpy view) is not seen: call :func:`clear_posterior_cache` after one."""
    with tracing.span("predict"):
        dev = resolve_device(device)
        check_on_device(dev, *_tensors(params, prev, x, chain_mask, *noise.values()))
        cfg_eval = eval_budget_cfg(cfg, n_f=n_f, n_var_samples=n_var_samples)
        _check_inputs(prev, x, noise, cfg_eval, with_kl=False)
        cp = _reused_posterior(params, prev, noise["hyper_eps"], cfg_eval, chain_mask, dev)
        f_mean, f_var = marginal_diag(cp, params, x, cfg_eval, chain_mask=chain_mask)
        with tracing.span("likelihood"):
            return softmax_predict(f_mean, f_var, noise["lik_eps"])


# ---------------------------------------------------------------------------
# predict's posterior memo: one entry, the last posterior built
# ---------------------------------------------------------------------------

# the environment knobs that choose the posterior's route
_ROUTE_KNOBS = ("VARGP_TPU_CHOLINV", "VARGP_TPU_AR_FORM")


class _Entry(NamedTuple):
    refs: tuple  # weakref.ref of each key tensor, in _tensors' order
    versions: tuple  # each key tensor's _version at the build
    static: tuple  # the config, device, route knobs and matmul precision
    cp: ChainPosterior


_entry: _Entry | None = None


def clear_posterior_cache() -> None:
    """Drop the posterior ``predict`` keeps, so that its next call builds."""
    global _entry
    _entry = None


def _drop(ref) -> None:
    """A key tensor was freed: drop its entry (and the posterior's memory)
    unless a newer entry has replaced it."""
    global _entry
    if _entry is not None and any(r is ref for r in _entry.refs):
        _entry = None


def _reused_posterior(params, prev, hyper_eps, cfg, chain_mask, dev) -> ChainPosterior:
    """``build_posterior``'s result, reused from the last call when its
    inputs are the same unchanged tensors.  Built and not kept while
    autograd records a key tensor, while ``torch.compile`` or
    ``torch.export`` traces, or for an inference tensor (which has no
    version counter)."""
    global _entry
    tensors = _tensors(params, prev, hyper_eps, chain_mask)
    grad = torch.is_grad_enabled()
    if torch.compiler.is_compiling() or any(
            t.is_inference() or (grad and t.requires_grad) for t in tensors):
        tracing.POSTERIOR["build"] += 1
        return build_posterior(params, prev, hyper_eps, cfg, chain_mask=chain_mask)
    static = (cfg, dev, *(os.environ.get(k) for k in _ROUTE_KNOBS),
              torch.get_float32_matmul_precision())
    versions = tuple(t._version for t in tensors)
    e = _entry
    if (e is not None and e.static == static and e.versions == versions
            and all(r() is t for r, t in zip(e.refs, tensors))):
        tracing.POSTERIOR["reuse"] += 1
        return e.cp
    _entry = None  # the old posterior's memory is free before the new one is built
    cp = build_posterior(params, prev, hyper_eps, cfg, chain_mask=chain_mask)
    _entry = _Entry(tuple(weakref.ref(t, _drop) for t in tensors), versions, static, cp)
    tracing.POSTERIOR["build"] += 1
    return cp


# ---------------------------------------------------------------------------
# Construction and task chaining
# ---------------------------------------------------------------------------


def median_log_lengthscale(data: torch.Tensor, n_sample: int = 512) -> torch.Tensor:
    """Log of the median nonzero pairwise distance of the first
    ``n_sample`` rows (the median of an even count is the mean of the two
    middle values, as ``jnp.median`` takes it), floored at log(1e-3)."""
    x = data[:n_sample]
    d2 = torch.sum(torch.square(x[:, None] - x[None]), dim=-1)
    med = torch.sqrt(torch.quantile(d2[d2 > 0], 0.5))
    return torch.log(torch.clamp(med, min=1e-3))


def _diag_mask_vec(m: int, device=None) -> torch.Tensor:
    """Packed row-major (m(m+1)/2,) vector: 1 on the diagonal, 0 elsewhere."""
    rows, cols = torch.tril_indices(m, m, device=device)
    return (rows == cols).to(torch.float32)


def init_params(kernel_eps: torch.Tensor, u_eps: torch.Tensor, z_init: torch.Tensor,
                cfg: VARGPConfig, *, kernel_prior_from: RBFParams | None = None,
                phi_uniform: Sequence[torch.Tensor] | None = None,
                phi_init: MLPParams | None = None,
                log_lengthscale_init=None) -> tuple[VARGPParams, RBFPrior]:
    """Trainable parameters of a new task and its kernel prior.

    ``kernel_eps`` (P+1,) and ``u_eps`` (O, M, 1) are the standard-normal
    draws of the JAX package's ``init_params`` (its kernel and u keys),
    P = ``_theta_size(cfg)``.  z_init (O, M, D) are the inducing inputs;
    the prior chains from the previous task's kernel posterior when given,
    else it is N(0, I); a given ``log_lengthscale_init`` replaces every
    log-lengthscale mean.  u_tril starts as the packed identity
    (softplus(1) on the diagonal).  Under DKL the feature map starts as a
    copy of ``phi_init`` when given, else from the U[0, 1) draws
    ``phi_uniform`` (``kernels.deep.init_mlp``)."""
    _check_supported(cfg)
    P = _theta_size(cfg)
    kernel = init_rbf(kernel_eps)
    if log_lengthscale_init is not None:
        ls = torch.as_tensor(log_lengthscale_init, dtype=kernel.log_mean.dtype,
                             device=kernel.log_mean.device)
        ls = torch.broadcast_to(ls, (P,))
        kernel = kernel._replace(log_mean=torch.cat([ls, kernel.log_mean[-1:]]))
    if kernel_prior_from is not None:
        prior = RBFPrior(kernel_prior_from.log_mean, kernel_prior_from.log_logvar)
    else:
        prior = default_prior(P, device=z_init.device)
    phi = None
    if cfg.dkl:
        if phi_init is not None:
            phi = MLPParams(*(tuple(t.detach().clone() for t in g) for g in phi_init))
        elif phi_uniform is not None:
            phi = init_mlp(phi_uniform, cfg.in_size)
        else:
            raise ValueError("dkl=True: pass phi_init or the phi_uniform draws")
    u_tril_vec = _diag_mask_vec(cfg.M, device=z_init.device).expand(cfg.out_size, -1)
    params = VARGPParams(
        z=z_init, u_mean=0.5 * u_eps, u_tril_vec=u_tril_vec.contiguous(), kernel=kernel,
        phi=phi,
    )
    return params, prior


def freeze_task(params: VARGPParams) -> TaskPosterior:
    """A trained task's chain entry: z, u_mean and the unpacked u_tril,
    detached copies."""
    return TaskPosterior(
        z=params.z.detach().clone(),
        u_mean=params.u_mean.detach().clone(),
        u_tril=gpmath.vec2tril(params.u_tril_vec.detach()),
    )


def select_inducing(gen: torch.Generator, data: torch.Tensor, M: int,
                    out_size: int) -> torch.Tensor:
    """M random data rows per class head, (out_size, M, D), drawn from
    ``gen`` on the data's device: without replacement when the data have
    at least M rows, with replacement when they have fewer (the duplicates
    are harmless: the jittered factorisation keeps the Gram PD)."""
    n = data.shape[0]
    if n >= M:
        idx = torch.stack([
            torch.randperm(n, generator=gen, device=data.device)[:M]
            for _ in range(out_size)
        ])
    else:
        idx = torch.randint(n, (out_size, M), generator=gen, device=data.device)
    return data[idx]
