"""The inputs of a deep-kernel (DKL) cell, made from ``--seed`` on the device.

The chain and the current task are ``inputs.py``'s, with the RBF kernel's
hyperparameters sized to the feature map's output (P + 1 entries, not
D + 1), and the feature map phi = Linear(D, 256), ReLU, Linear(256, 256),
ReLU, Linear(256, 64) besides.  phi starts at ``torch.nn.Linear``'s default
initialisation, U(-1/sqrt(fan_in), 1/sqrt(fan_in)), made from U[0, 1)
draws as the port's ``kernels.deep.init_mlp`` maps them (copied here so
that the yardstick stays as it is).  The lengthscales start at the median
distance of phi's features over the chain's first 512 inducing rows
(``chip_smoke.py::flagship_model(dkl=True)``, the experiment scripts'
``ls_init='median'``), so every Gram entry is O(1).

Everything is drawn from one ``torch.Generator`` on the device, in the
order ``make_problem`` gives: the chain, phi layer by layer (the weight's
draw, then the bias's), then the current task.
"""

import math

import torch

from benchmark import inputs
from benchmark.reference import vargp as R
from benchmark.reference import vargp_dkl as RD


def init_phi(gen: torch.Generator, dims: list) -> list:
    """[W0, b0, W1, b1, ...]: each weight (in, out), each bias (out,), from
    U[0, 1) draws u mapped to max(-b, 2 b u - b), b = 1 / sqrt(in)."""
    out = []
    for a, b in zip(dims, dims[1:]):
        bound = 1.0 / math.sqrt(a)
        for shape in ((a, b), (b,)):
            u = torch.rand(shape, generator=gen, device=gen.device)
            out.append(torch.clamp(u * (2.0 * bound) - bound, min=-bound))
    return out


def make_problem(gen: torch.Generator, cfg: dict) -> tuple:
    """(``inputs.Problem``, phi): the chain of ``cfg["task"]`` earlier tasks,
    the current task and its prior over P + 1 hyperparameters, and phi as
    ``init_phi`` gives it, at the configuration's ``phi_widths``."""
    O, M, D = (cfg["model"][k] for k in ("out_size", "M", "in_size"))
    dims = cfg["phi_widths"]
    if dims[0] != D:
        raise ValueError(f"phi_widths {dims} do not start at in_size {D}")
    P = dims[-1]
    n_tri = M * (M + 1) // 2
    chain = []
    for _ in range(cfg["task"]):
        chain.append({"z": 0.1 * inputs.normal(gen, O, M, D),
                      "u_mean": 0.3 * inputs.normal(gen, O, M, 1),
                      "u_tril_vec": 0.1 * inputs.normal(gen, O, n_tri)})
    phi = init_phi(gen, dims)
    rows = torch.cat([t["z"] for t in chain], dim=-2).reshape(-1, D)
    log_ls = inputs.median_log_lengthscale(RD.features(R.F64, phi, rows))
    rows_, cols = torch.tril_indices(M, M, device=gen.device)
    eye_vec = (rows_ == cols).to(torch.float32)
    log_mean = torch.cat([log_ls + 0.05 * inputs.normal(gen, P),
                          torch.full((1,), math.log(0.5), device=gen.device)])
    current = {
        "z": 0.1 * inputs.normal(gen, O, M, D),
        "u_mean": 0.5 * inputs.normal(gen, O, M, 1),
        "u_tril_vec": eye_vec + 0.05 * inputs.normal(gen, O, n_tri),
        "log_mean": log_mean,
        "log_logvar": torch.full((P + 1,), -2.0, device=gen.device),
    }
    prior = {"log_mean": log_mean + 0.05 * inputs.normal(gen, P + 1),
             "log_logvar": -2.0 + 0.1 * inputs.normal(gen, P + 1)}
    return inputs.Problem(current=current, chain=chain, prior=prior), phi


def predict_noise(gen: torch.Generator, cfg: dict, n_var_samples: int, n_f: int,
                  batch_size: int) -> dict:
    """One evaluated split's noise at the evaluation's budgets, the hyper
    noise over P + 1 entries."""
    O, P = cfg["model"]["out_size"], cfg["phi_widths"][-1]
    return {"hyper_eps": inputs.normal(gen, n_var_samples, P + 1),
            "lik_eps": inputs.normal(gen, n_var_samples, n_f, O, batch_size)}
