"""Predictor export for serving.

Counterpart of ``vargp_tpu/utils/export.py``.  A deployed VAR-GP
classifier is a fixed prediction function: the chain and the current
task's parameters, a fixed evaluation budget and batch size.
``torch.export`` traces ``models.vargp.predict`` into a graph in which
each kernel launch is one ``vargp_torch::`` operator node, and saves it
as a ``.pt2`` file that a serving process loads and runs without this
package's Python code on the path of a call.

Inputs differ from the JAX package's: ``jax.export`` takes a PRNG key and
draws inside the program, while the port's ``predict`` takes its noise as
tensors and ``torch.export`` takes no ``torch.Generator``.  The exported
program's inputs are ``x`` and the two noise tensors ``predict`` reads,
``hyper_eps`` (n_var_samples, P+1) and ``lik_eps`` (H, n_f, O, B).

The route through the factorisation is read when the program is traced:
``VARGP_TPU_CHOLINV`` and ``VARGP_TPU_AR_FORM`` as they are set at export
time choose the operators in the graph (K3 and products, or K6), and the
saved program keeps that route whatever they say when it runs.
"""

import json
import os

import torch

from vargp_tpu_torch.models import vargp as V
from vargp_tpu_torch.ops.device import resolve_device

_META = "vargp_predictor.json"


def noise_shapes(cfg: V.VARGPConfig, batch_size: int) -> dict:
    """The shapes of the noise tensors ``predict`` reads under ``cfg``'s
    evaluation budget."""
    H = 1 if cfg.map_est_hypers else cfg.n_var_samples
    return {"hyper_eps": (cfg.n_var_samples, V._theta_size(cfg) + 1),
            "lik_eps": (H, cfg.n_f, cfg.out_size, batch_size)}


class _Predictor(torch.nn.Module):
    """predict(params, prev, x, noise, cfg) with the parameters and the
    chain as constants."""

    def __init__(self, params, prev, cfg, device):
        super().__init__()
        self.params, self.prev, self.cfg, self.device = params, tuple(prev), cfg, device

    def forward(self, x, hyper_eps, lik_eps):
        noise = {"hyper_eps": hyper_eps, "lik_eps": lik_eps}
        return V.predict(self.params, self.prev, x, noise, self.cfg, device=self.device)


def export_predictor(params, prev, cfg: V.VARGPConfig, batch_size: int, path: str, *,
                     n_f: int = 50, n_var_samples: int = 20, device=None) -> str:
    """Save predict(x, noise) -> (B, out_size) probabilities to ``path``
    (a ``.pt2`` file), for ``batch_size`` rows of ``cfg.in_size`` features
    at the budget (``n_f``, ``n_var_samples``), traced under ``no_grad``
    on ``device`` (None means the card), where ``params`` and ``prev``
    must lie."""
    dev = resolve_device(device)
    cfg_eval = V.eval_budget_cfg(cfg, n_f=n_f, n_var_samples=n_var_samples)
    shapes = noise_shapes(cfg_eval, batch_size)
    args = (torch.zeros((batch_size, cfg.in_size), device=dev),
            torch.zeros(shapes["hyper_eps"], device=dev), torch.zeros(shapes["lik_eps"], device=dev))
    with torch.no_grad():
        ep = torch.export.export(_Predictor(params, prev, cfg_eval, dev), args)
    meta = {"device": dev.type, "batch_size": batch_size, "in_size": cfg.in_size,
            "noise_shapes": shapes}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(ep, path, extra_files={_META: json.dumps(meta)})
    return path


def load_predictor(path: str, device=None):
    """Load an exported predictor; returns a callable (x, noise) -> probs,
    ``noise`` a dict with ``hyper_eps`` and ``lik_eps``.  The program runs
    on the device it was exported on, which ``device`` (None means the
    card) must name.  (Importing this module registers the
    ``vargp_torch::`` operators the program calls.)"""
    dev = resolve_device(device)
    extra = {_META: ""}
    ep = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[_META])
    if meta["device"] != dev.type:
        raise ValueError(f"{path} was exported for {meta['device']}, not {dev}")
    module = ep.module()

    def predict(x: torch.Tensor, noise: dict) -> torch.Tensor:
        return module(x, noise["hyper_eps"], noise["lik_eps"])

    predict.meta = meta
    predict.program = ep
    return predict
