"""Sparse-GP regression with the Gaussian likelihood; counterpart of
``vargp_tpu/experiments/regression.py``: a single-task SVGP with Bayesian
RBF hyperparameters on a synthetic 1-D function (sin 3x + 0.3x, noise
sigma 0.1), 800 full-batch Yogi steps, then the train RMSE over 16 hyper
samples.

The data and the inducing rows come from ``numpy.random.default_rng(seed)``
as in the JAX driver, so both packages train on the same arrays.  The
parameters are a ``RegressionParams`` whose fields follow the JAX
driver's dict in its flattening (sorted-key) order, so an optax Yogi state
of that dict converts leaf for leaf.  Every draw goes through one draw
source (``RegressionDraws`` over a ``torch.Generator`` from the seed): the
kernel's initial noise, each step's hyper samples and the final
evaluation's.  A step launches K5 twice (K_zz, symmetric, and K_zx
against the N points) and K7 once.
"""

from typing import NamedTuple

import numpy as np
import torch

from vargp_tpu_torch import gpmath
from vargp_tpu_torch.experiments.vargp_run import _log_dir
from vargp_tpu_torch.kernels import (
    RBFParams,
    default_prior,
    gram,
    gram_diag,
    init_rbf,
    kl_hypers,
    sample_hypers,
)
from vargp_tpu_torch.likelihoods import (
    GaussianLikParams,
    gaussian_loss,
    gaussian_predict,
    init_gaussian,
)
from vargp_tpu_torch.ops.device import resolve_device
from vargp_tpu_torch.train.loop import gradient_step
from vargp_tpu_torch.train.optim import Yogi
from vargp_tpu_torch.utils.logging import MetricsLogger
from vargp_tpu_torch.utils.prng import seed_everything, task_generator


class RegressionParams(NamedTuple):
    """The JAX driver's parameter dict, its keys in sorted order."""

    kernel: RBFParams
    lik: GaussianLikParams
    u_mean: torch.Tensor  # (1, M, 1)
    u_tril_vec: torch.Tensor  # (1, M(M+1)/2)
    z: torch.Tensor  # (1, M, 1)


def _make_data(rng: np.random.Generator, n: int = 256):
    """x (n, 1) sorted in [-3, 3], y (1, n) = sin 3x + 0.3x + N(0, 0.1^2)."""
    x = np.sort(rng.uniform(-3, 3, n)).astype(np.float32)[:, None]
    y = (np.sin(3 * x[:, 0]) + 0.3 * x[:, 0]).astype(np.float32)
    y = y + 0.1 * rng.standard_normal(n).astype(np.float32)
    return x, y[None, :]


def _forward(params: RegressionParams, x: torch.Tensor, hyper_eps: torch.Tensor,
             jitter: float = gpmath.DEFAULT_JITTER):
    """The marginals (mu, var), each (H, 1, N), and (L, u_tril), theta
    from hyper_eps (H, 2)."""
    theta = sample_hypers(params.kernel, hyper_eps)
    u_tril = gpmath.vec2tril(params.u_tril_vec)
    L = gpmath.sym_cholesky(gram(theta, params.z), jitter)  # K5 symmetric, K7
    Kzx = gram(theta, params.z, x.expand(1, *x.shape))  # K5 cross
    mu, var = gpmath.whitened_marginal_diag(L, params.u_mean, u_tril, Kzx, gram_diag(theta))
    return mu, var, (L, u_tril)


def elbo(params: RegressionParams, prior, x, y, hyper_eps, beta: float = 1.0):
    """(beta * kl_hypers + kl_u + nll, (nll,)), ``train.loop.gradient_step``'s
    objective: kl_u the classes summed and the hypers averaged, nll
    ``gaussian_loss``'s."""
    mu, var, (L, u_tril) = _forward(params, x, hyper_eps)
    nll = gaussian_loss(params.lik, mu, var, y)
    u_mean = params.u_mean[..., 0]
    kl = gpmath.mvn_kl(u_mean, u_tril, torch.zeros_like(u_mean), L)
    klu = torch.mean(torch.sum(kl, dim=-1))
    return beta * kl_hypers(params.kernel, prior) + klu + nll, (nll,)


class RegressionDraws:
    """The driver's draws from one ``torch.Generator``: ``init`` (the
    kernel's initial noise (2,)), then ``hypers(n)`` (n, 2) for every step
    and for the final evaluation."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def init(self) -> torch.Tensor:
        return torch.randn((2,), generator=self.gen, device=self.gen.device)

    def hypers(self, n: int) -> torch.Tensor:
        return torch.randn((n, 2), generator=self.gen, device=self.gen.device)


def regression(epochs=800, M=24, lr=1e-2, n_var_samples=3, beta=1.0, seed=0, log_dir=None,
               device=None, draws=None):
    """Train and report the train RMSE of the predictive mean (averaged over
    16 hyper samples); returns (params, rmse).  ``device=None`` means the
    card; ``draws`` replaces the draw source."""
    dev = resolve_device(device)
    root, seed = seed_everything(seed)
    log_dir = log_dir or _log_dir("regression")
    rng = np.random.default_rng(seed)
    x_np, y_np = _make_data(rng)
    idx = rng.permutation(len(x_np))[:M]
    x, y = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev)
    draws = draws or RegressionDraws(task_generator(root, 0, dev))
    params = RegressionParams(
        kernel=init_rbf(draws.init()), lik=init_gaussian(1, device=dev),
        u_mean=torch.zeros((1, M, 1), device=dev),
        u_tril_vec=torch.full((1, gpmath.tril_size(M)), 0.5, device=dev),
        z=torch.from_numpy(x_np[idx]).to(dev)[None])
    prior = default_prior(1, device=dev)
    opt = Yogi(lr)
    opt_state = opt.init(params)
    with MetricsLogger(log_dir) as logger:
        for e in range(epochs):
            h = draws.hypers(n_var_samples)
            params, opt_state, loss, _ = gradient_step(
                params, opt_state, lambda p: elbo(p, prior, x, y, h, beta), opt)
            if (e + 1) % 100 == 0:
                logger.add_scalar("regression/loss", float(loss), step=e + 1)
    with torch.no_grad():
        mu, var, _ = _forward(params, x, draws.hypers(16))
        pred = gaussian_predict(params.lik, mu, var).mean(0)[0]
    rmse = float(torch.sqrt(torch.mean(torch.square(pred - y[0]))))
    print(f"[regression] train RMSE {rmse:.4f} (noise sigma 0.1)")
    return params, rmse
