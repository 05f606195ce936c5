"""Reference-checkpoint migration.

Counterpart of ``vargp_tpu/utils/torch_compat.py``.  The reference (the
upstream PyTorch VAR-GP code) saves one ``state_dict`` per task
(``ckpt{t}.pt``) with the keys ``z``, ``u_mean``, ``u_tril_vec``,
``kernel.log_mean``, ``kernel.log_logvar``, ``kernel.prior_log_mean``,
``kernel.prior_log_logvar`` and, under the deep kernel,
``kernel.phi.{0,2,4}.{weight,bias}`` (a ``Sequential`` of Linear, ReLU,
Linear, ReLU, Linear).  This module maps those keys directly onto the
port's ``VARGPParams`` and ``RBFPrior``: the tensors as they are, in
float32 on the device asked for, and each Linear weight transposed from
its (out, in) storage to the port's (in, out).  A state dict may also be
a plain ``{key: numpy array}`` mapping.
"""

import numpy as np
import torch

from vargp_tpu_torch.kernels import MLPParams, RBFParams, RBFPrior
from vargp_tpu_torch.models.vargp import VARGPParams
from vargp_tpu_torch.ops.device import resolve_device

_PHI_LAYERS = (0, 2, 4)  # the Linear layers of the reference's Sequential


def _tensor(v, device: torch.device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to(device=device, dtype=torch.float32).contiguous()
    return torch.tensor(np.asarray(v), dtype=torch.float32, device=device)


def params_from_state_dict(state_dict, device=None) -> VARGPParams:
    """One task's ``VARGPParams`` from a reference VARGP ``state_dict``, on
    ``device`` (None means the card); the deep kernel's MLP when the dict
    holds ``kernel.phi.*`` keys."""
    dev = resolve_device(device)
    t = lambda k: _tensor(state_dict[k], dev)  # noqa: E731
    phi = None
    if any(k.startswith("kernel.phi.") for k in state_dict):
        phi = MLPParams(
            weights=tuple(t(f"kernel.phi.{i}.weight").T.contiguous() for i in _PHI_LAYERS),
            biases=tuple(t(f"kernel.phi.{i}.bias") for i in _PHI_LAYERS),
        )
    return VARGPParams(
        z=t("z"), u_mean=t("u_mean"), u_tril_vec=t("u_tril_vec"),
        kernel=RBFParams(log_mean=t("kernel.log_mean"), log_logvar=t("kernel.log_logvar")),
        phi=phi,
    )


def prior_from_state_dict(state_dict, device=None) -> RBFPrior:
    """The kernel's hyperprior buffers of a reference ``state_dict``."""
    dev = resolve_device(device)
    return RBFPrior(log_mean=_tensor(state_dict["kernel.prior_log_mean"], dev),
                    log_logvar=_tensor(state_dict["kernel.prior_log_logvar"], dev))


def chain_from_torch_checkpoints(paths, device=None) -> list:
    """[ckpt0.pt .. ckptT.pt] as a chain of ``VARGPParams`` on ``device``,
    each file read with ``torch.load(..., map_location=device)``."""
    dev = resolve_device(device)
    return [params_from_state_dict(torch.load(p, map_location=dev), device=dev) for p in paths]
