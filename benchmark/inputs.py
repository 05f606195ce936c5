"""The inputs of a cell, made from ``--seed`` on the device.

Parameters and data are random, at the configuration's widths, with the
recipe of the port's smoke checks (``chip_smoke.py::flagship_model``,
copied here so that the yardstick stays as it is): rows are N(0, 0.01)
pixels at MNIST's 784 features, so that the pairwise distances sit near
their median, and the lengthscales start at that median distance (the
port's ``median_log_lengthscale``: the square root of the median nonzero
squared distance of the first 512 rows), so every Gram entry is O(1).
The chain's earlier tasks and the current task's parameters are draws of
the same sizes a trained chain has.  Real MNIST images are not in the
repository; the work depends on the shapes alone.

Everything is drawn from one ``torch.Generator`` on the device, in large
calls, in the order ``make_problem`` gives, so one seed gives the same
inputs in every run.
"""

import math
from dataclasses import dataclass

import torch


@dataclass
class Problem:
    """Raw inputs: the current task's parameters (``current``: z, u_mean,
    u_tril_vec, log_mean, log_logvar), the earlier tasks' frozen entries
    (``chain``: z, u_mean, u_tril_vec each) and the kernel prior."""

    current: dict
    chain: list
    prior: dict


def normal(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device)


def rows(gen: torch.Generator, n: int, D: int) -> torch.Tensor:
    """n data rows of D pixels, N(0, 0.01)."""
    return 0.1 * normal(gen, n, D)


def train_set(gen: torch.Generator, cfg: dict):
    """(x, y, w) on the device: ``cfg["train_rows"]`` rows with uniform
    labels, padded with zero-weight rows to a multiple of the batch at or
    above the ``train`` group's ``pad_data_rows``."""
    m, hp = cfg["model"], cfg["train"]
    B, n, D = hp["batch_size"], cfg["train_rows"], m["in_size"]
    n_pad = -(-max(n, hp["pad_data_rows"]) // B) * B
    dev = gen.device
    x = torch.zeros((n_pad, D), device=dev)
    x[:n] = rows(gen, n, D)
    y = torch.zeros((n_pad,), dtype=torch.int64, device=dev)
    y[:n] = torch.randint(m["out_size"], (n,), generator=gen, device=dev)
    w = torch.zeros((n_pad,), device=dev)
    w[:n] = 1.0
    return x, y, w


def median_log_lengthscale(x: torch.Tensor, n_sample: int = 512) -> float:
    """Log of the median nonzero pairwise distance of the first
    ``n_sample`` rows (the median of an even count is the mean of the two
    middle values), floored at log(1e-3)."""
    a = x[:n_sample].double()
    sq = torch.sum(a * a, dim=-1)
    d2 = torch.clamp(sq[:, None] + sq[None] - 2.0 * a @ a.T, min=0.0)
    off = ~torch.eye(a.shape[0], dtype=torch.bool, device=a.device)
    d2 = d2[off]
    med = torch.sqrt(torch.quantile(d2[d2 > 0], 0.5))
    return math.log(max(float(med), 1e-3))


def make_problem(gen: torch.Generator, cfg: dict, data: torch.Tensor) -> Problem:
    """The chain of ``cfg["task"]`` earlier tasks, the current task and its
    prior, the lengthscales at ``data``'s median distance."""
    O, M, D = (cfg["model"][k] for k in ("out_size", "M", "in_size"))
    n_tri = M * (M + 1) // 2
    log_ls = median_log_lengthscale(data)
    chain = []
    for _ in range(cfg["task"]):
        chain.append({"z": 0.1 * normal(gen, O, M, D), "u_mean": 0.3 * normal(gen, O, M, 1),
                      "u_tril_vec": 0.1 * normal(gen, O, n_tri)})
    rows_, cols = torch.tril_indices(M, M, device=gen.device)
    eye_vec = (rows_ == cols).to(torch.float32)
    log_mean = torch.cat([log_ls + 0.05 * normal(gen, D),
                          torch.full((1,), math.log(0.5), device=gen.device)])
    current = {
        "z": 0.1 * normal(gen, O, M, D),
        "u_mean": 0.5 * normal(gen, O, M, 1),
        "u_tril_vec": eye_vec + 0.05 * normal(gen, O, n_tri),
        "log_mean": log_mean,
        "log_logvar": torch.full((D + 1,), -2.0, device=gen.device),
    }
    # the previous task's kernel posterior, which the current task's prior
    # is chained from
    prior = {"log_mean": log_mean + 0.05 * normal(gen, D + 1),
             "log_logvar": -2.0 + 0.1 * normal(gen, D + 1)}
    return Problem(current=current, chain=chain, prior=prior)


def step_noise(gen: torch.Generator, cfg: dict, batch_size: int) -> dict:
    """One training step's noise: hyper samples, the prefix draws of the
    earlier tasks (when there are any) and the function samples."""
    m = cfg["model"]
    H = n_v = m["n_var_samples"]
    O, D = m["out_size"], m["in_size"]
    noise = {"hyper_eps": normal(gen, n_v, D + 1)}
    if cfg["task"]:
        noise["prefix_eps"] = normal(gen, n_v, H, O, cfg["task"] * m["M"])
    noise["lik_eps"] = normal(gen, H, m["n_f"], O, batch_size)
    return noise


def block_draws(gen: torch.Generator, cfg: dict, n_pad: int, batch_size: int, n_epochs: int):
    """A train block's (row indices, noise) step by step, drawn lazily as
    the block consumes them: per epoch one permutation of the padded rows,
    then each step's noise."""
    for _ in range(n_epochs):
        perm = torch.randperm(n_pad, generator=gen, device=gen.device)
        for s in range(n_pad // batch_size):
            yield perm[s * batch_size:(s + 1) * batch_size], step_noise(gen, cfg, batch_size)


def predict_noise(gen: torch.Generator, cfg: dict, n_var_samples: int, n_f: int,
                  batch_size: int) -> dict:
    """One evaluated split's noise at the evaluation's budgets."""
    O, D = cfg["model"]["out_size"], cfg["model"]["in_size"]
    return {"hyper_eps": normal(gen, n_var_samples, D + 1),
            "lik_eps": normal(gen, n_var_samples, n_f, O, batch_size)}


def pass_seed(seed: int, k: int) -> int:
    """The seed of the k-th pass over a split: every pass's noise can be
    drawn again once the window has closed."""
    return (seed * 1_000_003 + 7919 * (k + 1)) % (1 << 63)
