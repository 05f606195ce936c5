"""Independent multi-output Gaussian likelihood.

Counterpart of ``vargp_tpu/likelihoods/gaussian.py`` (the reference's
likelihoods.py:66-110, which no experiment of the reference uses; the
regression driver does): a learned observation noise per output added to
the GP marginal's variance.
"""

import math
from typing import NamedTuple

import torch

from vargp_tpu_torch.ops.device import resolve_device


class GaussianLikParams(NamedTuple):
    obs_log_var: torch.Tensor  # (out_size,)


def init_gaussian(out_size: int, init_log_var: float = -4.0, *, device=None) -> GaussianLikParams:
    """log noise variance ``init_log_var`` for every output, on ``device``
    (None means the card)."""
    return GaussianLikParams(
        obs_log_var=torch.full((out_size,), init_log_var, device=resolve_device(device)))


def _obs_moments(params: GaussianLikParams, mu: torch.Tensor, var: torch.Tensor):
    """mu, var (n_hypers, out_size, B) -> the observation's mean and
    variance, the learned per-output noise added."""
    return mu, var + torch.exp(params.obs_log_var)[None, :, None]


def gaussian_loss(params: GaussianLikParams, mu: torch.Tensor, var: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """-E[log N(y; mu, var + noise)] as the reference reduces it: the mean
    over hypers and outputs, the sum over the batch.  y (out_size, B)."""
    obs_mu, obs_var = _obs_moments(params, mu, var)
    log_prob = -0.5 * (math.log(2.0 * math.pi) + torch.log(obs_var)
                       + torch.square(y[None] - obs_mu) / obs_var)
    return -torch.sum(torch.mean(log_prob, dim=(0, 1)))


def gaussian_predict(params: GaussianLikParams, mu: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """The posterior predictive mean: mu."""
    return mu
