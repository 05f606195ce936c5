"""The VAR-GP Retrain ablation: every task's variational parameters stay
trainable, and the ELBO regularises them with KL(q(u_{<=t}) ||
p(u_{<=t} | theta)) plus an importance term E[log p(u~_{<t}) -
log q~(u~_{<t})], u~ drawn through the chain's conditional at the
original (frozen) inducing points.

Counterpart of ``vargp_tpu/models/vargp_retrain.py``.  Every random draw
is an explicit tensor in ``noise``:

  ``hyper_eps`` (n_var_samples, D+1)            hyper-sample noise
  ``lik_eps``   (H, n_f, O, B)                  function-sample noise
  ``u_eps``     (n_var_samples, H, O, S)        draws of u_{<=t} ~ q (S chain rows)
  ``ut_eps``    (n_var_samples, n_var_samples,  draws of u~_{<t} given u_{<=t}
                 H, O, c)                       (c frozen rows)

the last two only with a previous task.  Both samples carry no gradient,
as in the JAX package (``stop_gradient``): the importance term reaches
the parameters only through the frozen chain's factor L~ and its
posterior, that is through theta.

Kernels: ``kernels.rbf.gram`` reaches K5 (up to 16 input features its
small kernel) and ``gpmath.cholesky`` K7.  A step launches K5 twice at
task 0 (the chain's self-Gram, symmetric, and K_zx against the batch) and
four times with a previous task (also K(z~, z~), symmetric, and
K(z_all, z~)); K7 once at task 0, three times after (the chain, the
frozen chain and the conditional covariance).  The JAX ``loss`` computes
K(z~, z~) twice, once for L~ and once for the conditional covariance;
here one Gram serves both.  At a task's first step z_all[:c] is a copy of
z~, so the conditional covariance K(z~, z~) - W^T W is rounding around 0
before its jitter: the shared entries of K(z~, z~) and K(z_all, z~) round
alike in K5's small kernel (each entry sums the same squared differences)
and every matrix is symmetrised before K7 (``gpmath.sym_cholesky``), as
``jnp.linalg.cholesky`` symmetrises its input.
"""

from dataclasses import dataclass
from typing import NamedTuple, Sequence

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
from vargp_tpu_torch.models.vargp import TaskPosterior
from vargp_tpu_torch.ops.device import check_on_device, resolve_device
from vargp_tpu_torch.train.optim import tree_leaves


class TaskRaw(NamedTuple):
    """One task's raw trainable parameters."""

    z: torch.Tensor  # (O, M, D)
    u_mean: torch.Tensor  # (O, M, 1)
    u_tril_vec: torch.Tensor  # (O, M(M+1)/2), row-major packing


class RetrainParams(NamedTuple):
    """Every task's raw parameters (the current task last) and the kernel,
    in the JAX package's field order (its checkpoints load with no
    remapping)."""

    tasks: tuple  # TaskRaw per task
    kernel: RBFParams


@dataclass(frozen=True)
class RetrainConfig:
    M: int
    out_size: int
    in_size: int
    n_f: int = 10
    n_var_samples: int = 3
    map_est_hypers: bool = False
    jitter: float = gpmath.DEFAULT_JITTER


def _chain(theta: torch.Tensor, tasks: Sequence[TaskRaw], jitter: float):
    """The chain's rows z_all, the factor L of their Gram and the AR joint
    posterior (the fold by triangular solves)."""
    z_all = torch.cat([t.z for t in tasks], dim=-2)
    L = gpmath.sym_cholesky(gram(theta, z_all), jitter)  # K5 symmetric, K7
    post = gpmath.ar_joint_posterior(
        L, [t.u_mean for t in tasks], [gpmath.vec2tril(t.u_tril_vec) for t in tasks])
    return z_all, L, post


def forward(params: RetrainParams, x: torch.Tensor, theta: torch.Tensor, cfg: RetrainConfig):
    """Diagonal predictive marginals (f_mean, f_var), each (H, O, B), and
    (z_all, L, post)."""
    z_all, L, post = _chain(theta, params.tasks, cfg.jitter)
    Kzx = gram(theta, z_all, x.expand(cfg.out_size, *x.shape))  # K5 cross
    f_mean, f_var = gpmath.whitened_marginal_diag(L, post.mean, post.LS, Kzx, gram_diag(theta))
    return f_mean, f_var, (z_all, L, post)


def _check_noise(noise: dict, cfg: RetrainConfig, B: int, S: int, c: int):
    H = 1 if cfg.map_est_hypers else cfg.n_var_samples
    n_v, O = cfg.n_var_samples, cfg.out_size
    want = {"hyper_eps": (n_v, cfg.in_size + 1), "lik_eps": (H, cfg.n_f, O, B)}
    if c:
        want["u_eps"] = (n_v, H, O, S)
        want["ut_eps"] = (n_v, n_v, H, O, c)
    for key, shape in want.items():
        got = noise.get(key)
        if got is None or tuple(got.shape) != shape:
            raise ValueError(
                f"noise[{key!r}]: expected shape {shape}, got "
                f"{None if got is None else tuple(got.shape)}"
            )


def importance_term(theta, z_all, L, post, frozen_prev: Sequence[TaskPosterior],
                    u_eps: torch.Tensor, ut_eps: torch.Tensor, jitter: float) -> torch.Tensor:
    """E[log p(u~_{<t} | theta) - log q~(u~_{<t} | theta)]: u_{<=t} ~ q
    (from ``u_eps``), then u~_{<t} ~ p(u~_{<t} | u_{<=t}, theta) at the
    frozen rows (from ``ut_eps``); the classes summed, the hypers and both
    sample axes averaged.  The samples carry no gradient."""
    z_tilde = torch.cat([p.z for p in frozen_prev], dim=-2)
    Ktt = gram(theta, z_tilde)  # K5 symmetric
    L_tilde = gpmath.sym_cholesky(Ktt, jitter)  # K7
    post_tilde = gpmath.ar_joint_posterior(
        L_tilde, [p.u_mean for p in frozen_prev], [p.u_tril for p in frozen_prev])
    with torch.no_grad():
        u_leq = gpmath.mvn_sample(post.mean[..., 0], post.LS, u_eps)  # (n_v, H, O, S)
        Kzx_t = gram(theta, z_all, z_tilde)  # K5 cross
        W = gpmath.tri_solve(L, Kzx_t)
        cond_mu = torch.einsum("...mi,...mb->...ib", gpmath.tri_solve(L, u_leq[..., None]),
                               W)[..., 0, :]  # (n_v, H, O, c)
        cond_cov = Ktt - torch.einsum("...mb,...mc->...bc", W, W)
        cond_L = gpmath.sym_cholesky(cond_cov, jitter)  # K7
        u_tilde = gpmath.mvn_sample(cond_mu, cond_L, ut_eps)  # (n_v, n_v, H, O, c)
    log_p = gpmath.mvn_log_prob(u_tilde, torch.zeros_like(cond_mu), L_tilde)
    log_q = gpmath.mvn_log_prob(u_tilde, post_tilde.mean[..., 0], post_tilde.LS)
    return torch.mean(torch.sum(log_p - log_q, dim=-1))


def _tensors(params, frozen_prev, *more):
    out = tree_leaves(params) + tree_leaves(tuple(frozen_prev))
    out.extend(t for t in more if isinstance(t, torch.Tensor))
    return out


def loss(params: RetrainParams, frozen_prev: Sequence[TaskPosterior], prior: RBFPrior,
         x: torch.Tensor, y: torch.Tensor, noise: dict, cfg: RetrainConfig,
         weights: torch.Tensor | None = None, *, device=None):
    """ELBO pieces (kl_hypers, kl_u, nll), the importance term folded into
    kl_u; a trainer combines them as beta*kl_hypers + kl_u + (N/B)*nll.
    ``frozen_prev`` is the snapshot of the previous tasks (``init_params``),
    empty at task 0.  ``weights`` masks padded batch rows.  ``device=None``
    means the card; every tensor must lie on it."""
    dev = resolve_device(device)
    check_on_device(dev, *_tensors(params, frozen_prev, *prior, x, y, weights, *noise.values()))
    S = sum(t.z.shape[-2] for t in params.tasks)
    c = sum(p.z.shape[-2] for p in frozen_prev)
    _check_noise(noise, cfg, x.shape[0], S, c)
    theta = sample_hypers(params.kernel, noise["hyper_eps"], map_est=cfg.map_est_hypers)
    f_mean, f_var, (z_all, L, post) = forward(params, x, theta, cfg)
    nll = softmax_loss(f_mean, f_var, y, noise["lik_eps"], weights=weights)
    klh = kl_hypers(params.kernel, prior, map_est=cfg.map_est_hypers)
    # KL(q(u_{<=t}) || N(0, K(z_{<=t}))): the classes summed, the hypers averaged
    mean = post.mean[..., 0]
    kl_u = torch.mean(torch.sum(gpmath.mvn_kl(mean, post.LS, torch.zeros_like(mean), L), dim=-1))
    if frozen_prev:
        kl_u = kl_u + importance_term(theta, z_all, L, post, frozen_prev, noise["u_eps"],
                                      noise["ut_eps"], cfg.jitter)
    return klh, kl_u, nll


def predict(params: RetrainParams, x: torch.Tensor, noise: dict, cfg: RetrainConfig, *,
            device=None) -> torch.Tensor:
    """Predictive class probabilities (B, out_size) from the whole chain;
    ``noise`` holds hyper_eps and lik_eps at the model's budgets."""
    dev = resolve_device(device)
    check_on_device(dev, *_tensors(params, (), x, *noise.values()))
    _check_noise(noise, cfg, x.shape[0], 0, 0)
    theta = sample_hypers(params.kernel, noise["hyper_eps"], map_est=cfg.map_est_hypers)
    f_mean, f_var, _ = forward(params, x, theta, cfg)
    return softmax_predict(f_mean, f_var, noise["lik_eps"])


def freeze_chain(tasks: Sequence[TaskRaw]) -> tuple:
    """The snapshot of trained tasks the importance term reads: detached
    copies of z and u_mean and the unpacked scale factor vec2tril(u_tril_vec)."""
    return tuple(
        TaskPosterior(z=t.z.detach().clone(), u_mean=t.u_mean.detach().clone(),
                      u_tril=gpmath.vec2tril(t.u_tril_vec.detach()))
        for t in tasks
    )


def init_params(kernel_eps: torch.Tensor, u_eps: torch.Tensor, z_init: torch.Tensor,
                cfg: RetrainConfig, prev_chain: Sequence[TaskRaw] = (),
                kernel_prior_from: RBFParams | None = None
                ) -> tuple[RetrainParams, RBFPrior, tuple]:
    """A new task from the standard-normal draws kernel_eps (D+1,) and u_eps
    (O, M, 1): u_mean = 0.5 u_eps, u_tril_vec all ones (off-diagonal
    included, as the reference has it).  The previous tasks' raw parameters
    stay trainable, ahead of the new task's.  Returns (params, prior,
    frozen_prev): the kernel prior is ``kernel_prior_from``'s posterior
    when given, else N(0, I); frozen_prev snapshots the previous chain
    (``freeze_chain``)."""
    kernel = init_rbf(kernel_eps)
    if kernel_prior_from is not None:
        prior = RBFPrior(kernel_prior_from.log_mean, kernel_prior_from.log_logvar)
    else:
        prior = default_prior(cfg.in_size, device=z_init.device)
    u_tril_vec = torch.ones((cfg.out_size, gpmath.tril_size(cfg.M)), device=z_init.device)
    current = TaskRaw(z=z_init, u_mean=0.5 * u_eps, u_tril_vec=u_tril_vec)
    params = RetrainParams(tasks=(*prev_chain, current), kernel=kernel)
    return params, prior, freeze_chain(prev_chain)


def params_template(cfg: RetrainConfig, n_tasks: int) -> RetrainParams:
    """A zero tree of ``n_tasks`` tasks at ``cfg``'s shapes on the CPU: the
    template ``utils.checkpoint.load_pytree`` reads ``ckpt{n_tasks - 1}``
    with."""
    O, M, D = cfg.out_size, cfg.M, cfg.in_size
    task = TaskRaw(torch.zeros(O, M, D), torch.zeros(O, M, 1),
                   torch.zeros(O, gpmath.tril_size(M)))
    return RetrainParams(tasks=(task,) * n_tasks,
                         kernel=RBFParams(torch.zeros(D + 1), torch.zeros(D + 1)))
