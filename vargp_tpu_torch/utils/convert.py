"""Carry parameters, optimizer state and noise between numpy and the port.

``params_from_numpy`` reads the JAX package's ``VARGPParams``,
``TaskPosterior`` and ``RBFPrior`` by field name, after the caller has run
``np.asarray`` on every leaf; ``opt_state_from_numpy`` reads an optax
Yogi/Adam state (``count``, ``mu``, ``nu``) the same way, or the phi-grouped
chain's state (a tuple holding that state and, with the freeze knob, a
``scale``).  Nothing of the
JAX package is imported.  ``params_to_numpy`` and ``opt_state_to_numpy``
go the other way, to numpy leaves in the JAX package's tree order
(z, u_mean, u_tril_vec, kernel.log_mean, kernel.log_logvar and, under the
deep kernel, phi.weights[0..2], phi.biases[0..2]).
``noise_for_loss`` / ``noise_for_predict`` build the ``noise`` dict of
``models.vargp`` from the draws the JAX path makes (hyper samples, prefix
draws, function samples).
"""

from typing import Sequence

import numpy as np
import torch

from vargp_tpu_torch.kernels import MLPParams, RBFParams, RBFPrior
from vargp_tpu_torch.models.vargp import TaskPosterior, VARGPParams
from vargp_tpu_torch.ops.device import resolve_device
from vargp_tpu_torch.train.optim import GroupState, OptState, tree_leaves, tree_unflatten


def to_tensor(a, device=None) -> torch.Tensor:
    """A contiguous f32 copy of ``a`` on ``device`` (None means the card)."""
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=resolve_device(device))


def _vargp_params(tree, t) -> VARGPParams:
    phi = getattr(tree, "phi", None)
    if phi is not None:
        phi = MLPParams(tuple(map(t, phi.weights)), tuple(map(t, phi.biases)))
    return VARGPParams(
        z=t(tree.z), u_mean=t(tree.u_mean), u_tril_vec=t(tree.u_tril_vec),
        kernel=RBFParams(t(tree.kernel.log_mean), t(tree.kernel.log_logvar)), phi=phi,
    )


def params_from_numpy(params, prev: Sequence = (), prior=None, *, device=None):
    """(VARGPParams, tuple of TaskPosterior, RBFPrior or None) on ``device``;
    the deep kernel's phi is carried when the tree has one."""
    dev = resolve_device(device)

    def t(a):
        return to_tensor(a, dev)

    p = _vargp_params(params, t)
    chain = tuple(TaskPosterior(t(e.z), t(e.u_mean), t(e.u_tril)) for e in prev)
    pr = None if prior is None else RBFPrior(t(prior.log_mean), t(prior.log_logvar))
    return p, chain, pr


def opt_state_from_numpy(state, *, device=None):
    """An optax ``ScaleByAdamState`` (count, and mu / nu of VARGPParams'
    structure) as the port's ``OptState`` on ``device``; the phi-grouped
    chain's state (a tuple of the parts' states) as a ``GroupState``, its
    phi scale 1 when the chain holds none."""
    dev = resolve_device(device)
    if not hasattr(state, "mu"):
        moments = next(s for s in state if hasattr(s, "mu"))
        scales = [s.scale for s in state if hasattr(s, "scale")]
        scale = np.asarray(scales[0] if scales else 1.0, dtype=np.float32)
        return GroupState(opt_state_from_numpy(moments, device=dev),
                          torch.tensor(scale, device=dev))
    count = torch.tensor(np.asarray(state.count), dtype=torch.int32, device=dev)
    return OptState(
        count, _vargp_params(state.mu, lambda a: to_tensor(a, dev)),
        _vargp_params(state.nu, lambda a: to_tensor(a, dev)),
    )


def params_to_numpy(params):
    """A parameter tree with every leaf as a numpy array, same structure."""
    return tree_unflatten(params, [t.detach().cpu().numpy() for t in tree_leaves(params)])


def opt_state_to_numpy(state):
    """``OptState`` with numpy leaves: count (int32 scalar), mu, nu; a
    ``GroupState`` as such a state and its phi scale (f32 scalar)."""
    if isinstance(state, GroupState):
        return GroupState(opt_state_to_numpy(state.moments),
                          np.asarray(state.phi_scale.cpu().numpy(), dtype=np.float32))
    return OptState(
        np.asarray(state.count.cpu().numpy(), dtype=np.int32),
        params_to_numpy(state.mu), params_to_numpy(state.nu),
    )


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
