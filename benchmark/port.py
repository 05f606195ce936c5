"""The program's objects made from the benchmark's inputs, shared by the
kinds of work (``kinds/<kind>.py``).

A configuration's ``model`` group holds ``VARGPConfig``'s fields and its
``train`` group ``TrainHyperparams``' fields; both are passed to the port
whole, so a configuration that sets another field of either needs no
edit here.
"""

from contextlib import contextmanager

import torch

from benchmark import inputs
from benchmark.reference import vargp as R


def port_modules():
    """The port's modules the kinds call: (``models.vargp``,
    ``train.loop``, ``kernels``)."""
    from vargp_tpu_torch import kernels
    from vargp_tpu_torch.models import vargp as V
    from vargp_tpu_torch.train import loop as TL

    return V, TL, kernels


def model_config(cfg: dict):
    """The configuration's ``model`` group as the port's ``VARGPConfig``."""
    V, _, _ = port_modules()
    return V.VARGPConfig(**cfg["model"])


def train_config(cfg: dict):
    """The configuration's ``train`` group as the port's ``TrainHyperparams``."""
    _, TL, _ = port_modules()
    return TL.TrainHyperparams(**cfg["train"])


def port_params(problem: inputs.Problem):
    """The problem as the program's objects: the current task's
    ``VARGPParams`` and the chain frozen by the program's ``freeze_task``."""
    V, _, kernels = port_modules()
    cur = problem.current
    params = V.VARGPParams(z=cur["z"], u_mean=cur["u_mean"], u_tril_vec=cur["u_tril_vec"],
                           kernel=kernels.RBFParams(cur["log_mean"], cur["log_logvar"]))
    prev = tuple(V.freeze_task(V.VARGPParams(z=t["z"], u_mean=t["u_mean"],
                                             u_tril_vec=t["u_tril_vec"], kernel=None))
                 for t in problem.chain)
    return params, prev


def leaves(params) -> dict:
    """The program's parameter tree by the reference's leaf names."""
    return {"z": params.z, "u_mean": params.u_mean, "u_tril_vec": params.u_tril_vec,
            "log_mean": params.kernel.log_mean, "log_logvar": params.kernel.log_logvar}


def reference_chain(chain: list, arith: R.Arith) -> list:
    """The earlier tasks in ``arith``'s dtype, their scale factors unpacked
    by the reference."""
    return [{"z": t["z"].to(arith.dtype), "u_mean": t["u_mean"].to(arith.dtype),
             "u_tril": R.unpack_tril(t["u_tril_vec"].to(arith.dtype), t["z"].shape[-2])}
            for t in chain]


def clone(tree: dict) -> dict:
    return {k: v.detach().clone() for k, v in tree.items()}


@contextmanager
def wrapped(module, name: str, make):
    """Replace ``module.name`` by ``make(original)`` for the block: how a
    kind plants a fault in the program's timed path."""
    original = getattr(module, name)
    setattr(module, name, make(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
