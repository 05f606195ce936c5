"""Move parameters and noise given as numpy arrays into the port.

``params_from_numpy`` reads the JAX package's ``VARGPParams``,
``TaskPosterior`` and ``RBFPrior`` by field name, after the caller has run
``np.asarray`` on every leaf; nothing of the JAX package is imported.
``noise_for_loss`` / ``noise_for_predict`` build the ``noise`` dict of
``models.vargp`` from the draws the JAX path makes (hyper samples, prefix
draws, function samples).
"""

from typing import Sequence

import numpy as np
import torch

from vargp_tpu_torch.kernels import RBFParams, RBFPrior
from vargp_tpu_torch.models.vargp import TaskPosterior, VARGPParams
from vargp_tpu_torch.ops.device import resolve_device


def to_tensor(a, device=None) -> torch.Tensor:
    """A contiguous f32 copy of ``a`` on ``device`` (None means the card)."""
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=resolve_device(device))


def params_from_numpy(params, prev: Sequence = (), prior=None, *, device=None):
    """(VARGPParams, tuple of TaskPosterior, RBFPrior or None) on ``device``."""
    if getattr(params, "phi", None) is not None:
        raise NotImplementedError("the deep kernel (phi) is not ported yet")
    dev = resolve_device(device)

    def t(a):
        return to_tensor(a, dev)

    p = VARGPParams(
        z=t(params.z), u_mean=t(params.u_mean), u_tril_vec=t(params.u_tril_vec),
        kernel=RBFParams(t(params.kernel.log_mean), t(params.kernel.log_logvar)),
    )
    chain = tuple(TaskPosterior(t(e.z), t(e.u_mean), t(e.u_tril)) for e in prev)
    pr = None if prior is None else RBFPrior(t(prior.log_mean), t(prior.log_logvar))
    return p, chain, pr


def noise_for_loss(hyper_eps, prefix_eps, lik_eps, *, device=None) -> dict:
    """``noise`` for ``loss``: hyper_eps (n_v, D+1), prefix_eps
    (n_v, H, O, c) or None for a task without a chain, lik_eps (H, n_f, O, B)."""
    dev = resolve_device(device)
    noise = {"hyper_eps": to_tensor(hyper_eps, dev), "lik_eps": to_tensor(lik_eps, dev)}
    if prefix_eps is not None:
        noise["prefix_eps"] = to_tensor(prefix_eps, dev)
    return noise


def noise_for_predict(hyper_eps, lik_eps, *, device=None) -> dict:
    """``noise`` for ``predict``: hyper_eps (n_v, D+1), lik_eps (H, n_f, O, B)."""
    return noise_for_loss(hyper_eps, None, lik_eps, device=device)
