"""Chain-reload analysis: the T x T accuracy and entropy matrices of a
saved checkpoint chain.

Counterpart of ``vargp_tpu/experiments/analysis.py`` (the S-MNIST,
P-MNIST and Split-Digits analyses; the toy, global-SVGP and comparison
deliverables and the plots come later).  Task t's model is
[ckpt0 .. ckpt_{t-1}] frozen plus ckpt_t, padded to the chain's length
with ``pad_chain``; row t of a matrix is that model, column s the test
split of task s.  The evaluation budget is the notebooks' (n_f = 50,
n_var_samples = 20), entropies are divided by ln(out_size).

Randomness: each cell draws its hyper-sample and function-sample noise
once, from one ``torch.Generator`` on the device, cell after cell in row
order, and every batch of the cell predicts with it, as the JAX package
uses one key per cell.  ``eval_draws`` yields the same draws again, so a
cell can be replayed elsewhere (on the CPU, say).

The default output file is ``analysis_torch.json`` beside the chain,
never the minted ``analysis.json``.
"""

import json
import os

import numpy as np
import torch

from vargp_tpu_torch import data
from vargp_tpu_torch.kernels import MLPParams, RBFParams
from vargp_tpu_torch.kernels.deep import DEFAULT_HIDDEN
from vargp_tpu_torch.models import vargp as V
from vargp_tpu_torch.ops.device import resolve_device
from vargp_tpu_torch.train.metrics import compute_acc_ent, compute_bwt
from vargp_tpu_torch.utils.checkpoint import load_chain
from vargp_tpu_torch.utils.convert import params_from_numpy

OUT_NAME = "analysis_torch.json"


def params_template(cfg: V.VARGPConfig) -> V.VARGPParams:
    """A tree of zero numpy arrays with the shapes of one task's parameters
    under ``cfg`` (the template a checkpoint is checked against)."""
    O, M, D, P = cfg.out_size, cfg.M, cfg.in_size, V._theta_size(cfg)
    z = np.zeros
    phi = None
    if cfg.dkl:
        dims = [D, DEFAULT_HIDDEN, DEFAULT_HIDDEN, P]
        phi = MLPParams(tuple(z((a, b), np.float32) for a, b in zip(dims, dims[1:])),
                        tuple(z((b,), np.float32) for b in dims[1:]))
    return V.VARGPParams(
        z=z((O, M, D), np.float32), u_mean=z((O, M, 1), np.float32),
        u_tril_vec=z((O, M * (M + 1) // 2), np.float32),
        kernel=RBFParams(z((P + 1,), np.float32), z((P + 1,), np.float32)), phi=phi,
    )


def load_task_chain(log_dir: str, n_tasks: int, cfg: V.VARGPConfig, *, device=None):
    """[ckpt0 .. ckpt_{n_tasks-1}] of ``log_dir`` as parameters on ``device``
    (None means the card)."""
    dev = resolve_device(device)
    chain = load_chain(log_dir, n_tasks, params_template(cfg))
    return [params_from_numpy(p, device=dev)[0] for p in chain]


def eval_draws(gen: torch.Generator, cfg: V.VARGPConfig, n_cells: int, batch_size: int):
    """The noise of ``n_cells`` cells in the order the analysis draws them:
    per cell, the hyper samples (n_var_samples, P+1) and then the function
    samples (H, n_f, out_size, batch_size), standard normal from ``gen``.
    ``cfg`` carries the evaluation budgets."""
    H = 1 if cfg.map_est_hypers else cfg.n_var_samples
    for _ in range(n_cells):
        yield {
            "hyper_eps": torch.randn((cfg.n_var_samples, V._theta_size(cfg) + 1),
                                     generator=gen, device=gen.device),
            "lik_eps": torch.randn((H, cfg.n_f, cfg.out_size, batch_size),
                                   generator=gen, device=gen.device),
        }


def accuracy_entropy_matrices(chain, cfg: V.VARGPConfig, test_sets, *, seed: int = 0,
                              n_f: int = 50, n_var_samples: int = 20,
                              batch_size: int = 512, device=None):
    """T x T accuracy and normalised-entropy matrices of a loaded chain
    (``load_task_chain``) over the per-task ``test_sets``; the cells' noise
    comes from a generator on ``device`` seeded with ``seed``."""
    dev = resolve_device(device)
    T = len(chain)
    cfg_eval = V.eval_budget_cfg(cfg, n_f=n_f, n_var_samples=n_var_samples)
    acc = np.zeros((T, T))
    ent = np.zeros((T, T))
    gen = torch.Generator(device=dev).manual_seed(seed)
    draws = eval_draws(gen, cfg_eval, T * len(test_sets), batch_size)
    with torch.no_grad():
        for t in range(T):
            prev, mask = V.pad_chain(tuple(V.freeze_task(p) for p in chain[:t]), cfg, t_max=T,
                                     device=dev)
            params = chain[t]
            for s, test_set in enumerate(test_sets):
                noise = next(draws)

                def predict(x):
                    return V.predict(params, prev, torch.from_numpy(x).to(dev), noise, cfg_eval,
                                     chain_mask=mask, device=dev)

                a, e = compute_acc_ent(test_set, predict, batch_size=batch_size)
                acc[t, s] = a
                ent[t, s] = e / np.log(cfg.out_size)
    return acc, ent


def summarize(acc: np.ndarray, ent: np.ndarray) -> dict:
    """Per-task final accuracies, their mean, BWT and both matrices."""
    return dict(
        final_accs=acc[-1].tolist(),
        final_avg_acc=float(acc[-1].mean()),
        bwt=compute_bwt(acc),
        acc_matrix=acc.tolist(),
        ent_matrix=ent.tolist(),
    )


def _write(summary: dict, log_dir: str, out_json: str | None) -> dict:
    out_json = out_json or os.path.join(log_dir, OUT_NAME)
    os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({k: v for k, v in summary.items() if "matrix" not in k}))
    return summary


def _split_tasks(test_full, n_tasks: int):
    return [data.filter_by_class(test_full, [2 * t, 2 * t + 1]) for t in range(n_tasks)]


def analyze_sdigits(log_dir: str, n_tasks: int = 5, M: int = 20, dkl: bool = False,
                    out_json: str | None = None, n_f: int = 50, n_var_samples: int = 20,
                    seed: int = 0, device=None) -> dict:
    """Split-Digits (scikit-learn's real digits): the matrices over the
    per-task test splits."""
    cfg = V.VARGPConfig(M=M, out_size=10, in_size=64, dkl=bool(dkl))
    chain = load_task_chain(log_dir, n_tasks, cfg, device=device)
    test_sets = _split_tasks(data.load_digits_dataset(train=False, seed=0), n_tasks)
    acc, ent = accuracy_entropy_matrices(chain, cfg, test_sets, seed=seed, n_f=n_f,
                                         n_var_samples=n_var_samples, device=device)
    return _write(summarize(acc, ent), log_dir, out_json)


def analyze_smnist(log_dir: str, data_dir=None, n_tasks: int = 5, M: int = 60,
                   dkl: bool = False, out_json: str | None = None, n_f: int = 50,
                   n_var_samples: int = 20, seed: int = 0, device=None) -> dict:
    """Split-MNIST (or its synthetic surrogate without the IDX files)."""
    cfg = V.VARGPConfig(M=M, out_size=10, in_size=784, dkl=bool(dkl))
    chain = load_task_chain(log_dir, n_tasks, cfg, device=device)
    test_sets = _split_tasks(data.load_mnist(data_dir, train=False), n_tasks)
    acc, ent = accuracy_entropy_matrices(chain, cfg, test_sets, seed=seed, n_f=n_f,
                                         n_var_samples=n_var_samples, device=device)
    return _write(summarize(acc, ent), log_dir, out_json)


def analyze_pmnist(log_dir: str, data_dir=None, n_tasks: int = 10, M: int = 100,
                   perm_seed: int = 0, out_json: str | None = None, n_f: int = 50,
                   n_var_samples: int = 20, seed: int = 0, device=None) -> dict:
    """Permuted-MNIST over the per-permutation test splits.  ``perm_seed``
    must be the training run's seed, for the permutations to agree: the
    numpy generator is consumed as the training run consumed it (the 10k
    validation split first, then the permutations)."""
    cfg = V.VARGPConfig(M=M, out_size=10, in_size=784)
    chain = load_task_chain(log_dir, n_tasks, cfg, device=device)
    rng = np.random.default_rng(perm_seed)
    data.split_train_val(data.load_mnist(data_dir, train=True), 10000, rng)
    perms = data.make_permutations(n_tasks, 784, rng)
    test_full = data.load_mnist(data_dir, train=False)
    test_sets = [data.apply_permutation(test_full, p) for p in perms]
    acc, ent = accuracy_entropy_matrices(chain, cfg, test_sets, seed=seed, n_f=n_f,
                                         n_var_samples=n_var_samples, device=device)
    return _write(summarize(acc, ent), log_dir, out_json)
