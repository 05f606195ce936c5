"""Chain-reload analysis: the T x T accuracy and entropy matrices of a
saved checkpoint chain.

Counterpart of ``vargp_tpu/experiments/analysis.py``: the S-MNIST,
P-MNIST, Split-Digits and toy analyses, the global SVGP's S-MNIST and toy
analyses, and the method comparisons (``compare_methods``,
``compare_vcl``).
Task t's VAR-GP model is [ckpt0 .. ckpt_{t-1}] frozen plus ckpt_t, padded
to the chain's length with ``pad_chain``; the global SVGP's is ckpt_t
alone (its predictions never read the earlier tasks).  Row t of a matrix
is that model, column s the test split of task s.  The evaluation budget
is the notebooks' (n_f = 50, n_var_samples = 20), entropies are divided
by ln(out_size).

Randomness: each cell draws its hyper-sample and function-sample noise
once, from one ``torch.Generator`` on the device, cell after cell in row
order, and every batch of the cell predicts with it, as the JAX package
uses one key per cell.  ``eval_draws`` yields the same draws again, so a
cell can be replayed elsewhere (on the CPU, say).

The default output file is ``analysis_torch.json`` beside the chain,
never the minted ``analysis.json``; the toys' are
``toy_density_torch.json`` and ``density_grid_torch.npz``.  The figures
the JAX analyses draw beside their JSON take the port's names too:
``matrices_torch.png``, ``inducing_torch.png`` (S-MNIST, P-MNIST,
Split-Digits), ``toy_density_torch.png``, in the directory of the JSON
(``out_json``'s when one is given, so that an analysis of a minted chain
into another directory writes nothing beside the chain); without
matplotlib (the card's machine) each is skipped with one printed line,
and the JSON is written.
``compare_vcl`` writes ``vcl_overlay_torch.json`` and
``vcl_overlay_<name>_torch.png``, never over the minted ``vcl_overlay*``.
"""

import json
import os

import numpy as np
import torch

from vargp_tpu_torch import data
from vargp_tpu_torch.experiments import plots
from vargp_tpu_torch.kernels import MLPParams, RBFParams
from vargp_tpu_torch.kernels.deep import DEFAULT_HIDDEN
from vargp_tpu_torch.models import global_svgp as G
from vargp_tpu_torch.models import vargp as V
from vargp_tpu_torch.ops.device import resolve_device
from vargp_tpu_torch.train.metrics import compute_acc_ent, compute_bwt
from vargp_tpu_torch.utils.checkpoint import load_chain
from vargp_tpu_torch.utils.convert import params_from_numpy

OUT_NAME = "analysis_torch.json"
MATRICES_PNG = "matrices_torch.png"
INDUCING_PNG = "inducing_torch.png"
TOY_DENSITY_PNG = "toy_density_torch.png"
VCL_JSON = "vcl_overlay_torch.json"


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


def _figure_dir(log_dir: str, out_json: str | None) -> str:
    """Where an analysis's figures go: beside its JSON, ``out_json``'s
    directory when one is given, else the chain's."""
    return log_dir if out_json is None else os.path.dirname(os.path.abspath(out_json))


def _figures(acc, ent, fig_dir: str, z=None, img_shape=(28, 28)) -> None:
    """The matrices' figure and, given the last task's inducing inputs
    ``z``, the inducing-input images, in ``fig_dir``."""
    plots.draw_or_skip(plots.plot_matrices, acc, ent, out_path=os.path.join(fig_dir, MATRICES_PNG))
    if z is not None:
        plots.draw_or_skip(plots.plot_inducing_images, z.detach().cpu().numpy(),
                           out_path=os.path.join(fig_dir, INDUCING_PNG), img_shape=img_shape)


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
    summary = _write(summarize(acc, ent), log_dir, out_json)
    _figures(acc, ent, _figure_dir(log_dir, out_json), chain[-1].z, img_shape=(8, 8))
    return summary


def analyze_smnist(log_dir: str, data_dir=None, n_tasks: int = 5, M: int = 60,
                   dkl: bool = False, out_json: str | None = None, n_f: int = 50,
                   n_var_samples: int = 20, seed: int = 0, device=None) -> dict:
    """Split-MNIST (or its synthetic surrogate without the IDX files)."""
    cfg = V.VARGPConfig(M=M, out_size=10, in_size=784, dkl=bool(dkl))
    chain = load_task_chain(log_dir, n_tasks, cfg, device=device)
    test_sets = _split_tasks(data.load_mnist(data_dir, train=False), n_tasks)
    acc, ent = accuracy_entropy_matrices(chain, cfg, test_sets, seed=seed, n_f=n_f,
                                         n_var_samples=n_var_samples, device=device)
    summary = _write(summarize(acc, ent), log_dir, out_json)
    _figures(acc, ent, _figure_dir(log_dir, out_json), chain[-1].z)
    return summary


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
    summary = _write(summarize(acc, ent), log_dir, out_json)
    _figures(acc, ent, _figure_dir(log_dir, out_json), chain[-1].z)
    return summary


def toy_density_grid(chain, cfg: V.VARGPConfig, lo: float = -3.0, hi: float = 3.0,
                     n: int = 60, *, gen: torch.Generator, n_f: int = 100,
                     n_var_samples: int = 20, device=None):
    """Each class's predictive probability over an n x n grid of [lo, hi]^2
    after each task (the reference's toy.ipynb cells 3-6): (grid_x,
    grid_y, probs (T, n, n, C)).  Each task's noise comes from ``gen``."""
    dev = resolve_device(device)
    xs = np.linspace(lo, hi, n, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs)
    pts = torch.from_numpy(np.stack([gx.ravel(), gy.ravel()], axis=-1)).to(dev)
    cfg_eval = V.eval_budget_cfg(cfg, n_f=n_f, n_var_samples=n_var_samples)
    draws = eval_draws(gen, cfg_eval, len(chain), n * n)
    out = []
    with torch.no_grad():
        for t, params in enumerate(chain):
            prev = tuple(V.freeze_task(p) for p in chain[:t])
            probs = V.predict(params, prev, pts, next(draws), cfg_eval, device=dev)
            out.append(probs.cpu().numpy().reshape(n, n, -1))
    return gx, gy, np.stack(out)


def analyze_toy(log_dir: str, n_tasks: int = 2, M: int = 20, out_json: str | None = None,
                n: int = 60, n_f: int = 100, n_var_samples: int = 20, data_seed: int = 0,
                seed: int = 0, device=None) -> dict:
    """The toy deliverable from a toy chain: the density grid
    (``density_grid_torch.npz``) and the density retention,
    density_retention[t] = the mean predicted probability of the true
    class over task 0's training points under the model after task t
    (``toy_density_torch.json``, or ``out_json``), and the density
    figure (``toy_density_torch.png``).  The noise comes from one generator
    seeded with ``seed``: the grid's draws, then each task's retention
    draws."""
    dev = resolve_device(device)
    cfg = V.VARGPConfig(M=M, out_size=4, in_size=2)
    chain = load_task_chain(log_dir, n_tasks, cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    gx, gy, probs = toy_density_grid(chain, cfg, n=n, gen=gen, n_f=n_f,
                                     n_var_samples=n_var_samples, device=dev)
    np.savez(os.path.join(log_dir, "density_grid_torch.npz"), gx=gx, gy=gy, probs=probs)

    toy_all = data.make_toy_dataset(seed=data_seed)
    task0 = data.filter_by_class(toy_all, [0, 1])
    cfg_eval = V.eval_budget_cfg(cfg, n_f=n_f, n_var_samples=n_var_samples)
    draws = eval_draws(gen, cfg_eval, len(chain), len(task0))
    x0 = torch.from_numpy(task0.data).to(dev)
    retention = []
    with torch.no_grad():
        for t, params in enumerate(chain):
            prev = tuple(V.freeze_task(p) for p in chain[:t])
            p = V.predict(params, prev, x0, next(draws), cfg_eval, device=dev).cpu().numpy()
            retention.append(float(np.mean(p[np.arange(len(task0)), task0.targets])))
    summary = dict(
        density_retention=retention, task0_true_class_prob_final=retention[-1],
        grid_n=n, n_f=n_f, n_var_samples=n_var_samples,
    )
    out_json = out_json or os.path.join(log_dir, "toy_density_torch.json")
    with open(out_json, "w") as f:
        json.dump(summary, f, indent=2)
    plots.draw_or_skip(plots.plot_toy_densities, gx, gy, probs, dataset=toy_all,
                       out_path=os.path.join(_figure_dir(log_dir, out_json), TOY_DENSITY_PNG))
    print(json.dumps(summary))
    return summary


# ---------------------------------------------------------------------------
# The global SVGP
# ---------------------------------------------------------------------------


def global_params_template(cfg: G.GlobalSVGPConfig) -> G.GlobalSVGPParams:
    """A tree of zero numpy arrays with the shapes of one global task's
    parameters under ``cfg``."""
    O, M, D = cfg.out_size, cfg.M, cfg.in_size
    z = np.zeros
    return G.GlobalSVGPParams(
        z=z((O, M, D), np.float32), u_mean=z((O, M, 1), np.float32),
        u_tril_vec=z((O, M * (M + 1) // 2), np.float32),
        kernel=RBFParams(z((D + 1,), np.float32), z((D + 1,), np.float32)),
    )


def load_global_chain(log_dir: str, cfgs, *, device=None):
    """[ckpt0 .. ckpt_{T-1}] of a global run, task t checked against
    ``cfgs[t]``'s template (M may grow from task to task), as parameters
    on ``device`` (None means the card)."""
    dev = resolve_device(device)
    chain = load_chain(log_dir, len(cfgs), [global_params_template(c) for c in cfgs])
    return [params_from_numpy(p, device=dev)[0] for p in chain]


def analyze_smnist_global(log_dir: str, data_dir=None, n_tasks: int = 5, M: int = 60,
                          grow_per_task: int = 0, out_json: str | None = None, n_f: int = 50,
                          n_var_samples: int = 20, batch_size: int = 512, seed: int = 0,
                          device=None) -> dict:
    """The T x T matrices of a global S-MNIST chain: row t is ckpt_t alone
    (M + grow_per_task t rows a class), column s task s's test split.  Each
    cell draws its noise once, cell after cell in row order, and every
    batch of the cell predicts with it (the JAX analysis reuses one key for
    a cell's batches)."""
    dev = resolve_device(device)
    cfgs = [G.GlobalSVGPConfig(M=M + grow_per_task * t, out_size=10, in_size=784)
            for t in range(n_tasks)]
    chain = load_global_chain(log_dir, cfgs, device=dev)
    test_sets = _split_tasks(data.load_mnist(data_dir, train=False), n_tasks)
    gen = torch.Generator(device=dev).manual_seed(seed)
    acc = np.zeros((n_tasks, n_tasks))
    ent = np.zeros((n_tasks, n_tasks))
    with torch.no_grad():
        for t in range(n_tasks):
            cfg_eval = V.eval_budget_cfg(cfgs[t], n_f=n_f, n_var_samples=n_var_samples)
            for s, test_set in enumerate(test_sets):
                noise = next(eval_draws(gen, cfg_eval, 1, batch_size))

                def predict(x):
                    return G.predict(chain[t], None, torch.from_numpy(x).to(dev), noise,
                                     cfg_eval, device=dev)

                a, e = compute_acc_ent(test_set, predict, batch_size=batch_size)
                acc[t, s] = a
                ent[t, s] = e / np.log(cfg_eval.out_size)
    summary = _write(summarize(acc, ent), log_dir, out_json)
    _figures(acc, ent, _figure_dir(log_dir, out_json))
    return summary


def analyze_toy_global(log_dir: str, n_tasks: int = 2, M: int = 20, out_json: str | None = None,
                       n: int = 60, n_f: int = 50, n_var_samples: int = 20, data_seed: int = 0,
                       seed: int = 0, device=None) -> dict:
    """The global toy deliverable (M growing as M (t + 1)): each task's
    predictive surfaces over an n x n grid of [-3, 3]^2
    (``density_grid_torch.npz``) and the task-0 density retention
    (``toy_density_torch.json``, or ``out_json``), as ``analyze_toy``
    defines it, from ckpt_t alone.  Per task, the grid's noise and then the
    retention's come from one generator seeded with ``seed``."""
    dev = resolve_device(device)
    cfgs = [G.GlobalSVGPConfig(M=M * (t + 1), out_size=4, in_size=2) for t in range(n_tasks)]
    chain = load_global_chain(log_dir, cfgs, device=dev)
    xs = np.linspace(-3.0, 3.0, n, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs)
    pts = torch.from_numpy(np.stack([gx.ravel(), gy.ravel()], axis=-1)).to(dev)
    toy_all = data.make_toy_dataset(seed=data_seed)
    task0 = data.filter_by_class(toy_all, [0, 1])
    x0 = torch.from_numpy(task0.data).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out, retention = [], []
    with torch.no_grad():
        for t, params in enumerate(chain):
            cfg_eval = V.eval_budget_cfg(cfgs[t], n_f=n_f, n_var_samples=n_var_samples)
            grid_noise = next(eval_draws(gen, cfg_eval, 1, n * n))
            ret_noise = next(eval_draws(gen, cfg_eval, 1, len(task0)))
            probs = G.predict(params, None, pts, grid_noise, cfg_eval, device=dev)
            out.append(probs.cpu().numpy().reshape(n, n, -1))
            p0 = G.predict(params, None, x0, ret_noise, cfg_eval, device=dev).cpu().numpy()
            retention.append(float(np.mean(p0[np.arange(len(task0)), task0.targets])))
    probs = np.stack(out)
    np.savez(os.path.join(log_dir, "density_grid_torch.npz"), gx=gx, gy=gy, probs=probs)
    summary = dict(
        density_retention=retention, task0_true_class_prob_final=retention[-1],
        grid_n=n, n_f=n_f, n_var_samples=n_var_samples,
    )
    out_json = out_json or os.path.join(log_dir, "toy_density_torch.json")
    with open(out_json, "w") as f:
        json.dump(summary, f, indent=2)
    plots.draw_or_skip(plots.plot_toy_densities, gx, gy, probs, dataset=toy_all,
                       out_path=os.path.join(_figure_dir(log_dir, out_json), TOY_DENSITY_PNG))
    print(json.dumps(summary))
    return summary


# ---------------------------------------------------------------------------
# Method comparisons
# ---------------------------------------------------------------------------


def _avg_after_task(m: np.ndarray) -> list:
    """The average accuracy over the tasks seen so far, after each task."""
    return [float(np.mean(m[i, : i + 1])) for i in range(m.shape[0])]


def compare_methods(ours, baselines: dict, out_json: str | None = None,
                    out_png: str | None = None) -> dict:
    """Our accuracy matrix against external baselines (VCL, say): each a
    T x T accuracy matrix, as an array or a file (.json with an
    ``acc_matrix`` key, e.g. any analysis's output; .csv; .npy).  Returns
    {method: {avg_acc_after_task, final_avg_acc, bwt}}, ours under
    ``vargp_tpu_torch``, and writes it to ``out_json`` and the curves'
    figure to ``out_png`` when given (the mnist.ipynb cells 6/15/19/24
    overlay)."""
    mats = {"vargp_tpu_torch": _load_acc_matrix(ours)}
    mats.update({k: _load_acc_matrix(v) for k, v in baselines.items()})
    out = {}
    for name, m in mats.items():
        avg_after = _avg_after_task(m)
        out[name] = dict(avg_acc_after_task=avg_after, final_avg_acc=avg_after[-1],
                         bwt=compute_bwt(m))
    if out_json:
        with open(out_json, "w") as f:
            json.dump(out, f, indent=2)
    if out_png:
        plots.draw_or_skip(plots.plot_method_comparison,
                           {k: v["avg_acc_after_task"] for k, v in out.items()}, out_path=out_png)
    return out


def compare_vcl(smnist_json: str = "results/smnist_r4/analysis.json",
                pmnist_json: str = "results/pmnist_r4/analysis.json",
                out_dir: str = "results/compare") -> dict:
    """The notebooks' VCL overlay (mnist.ipynb cells 6/19): the average
    accuracy after each task of the minted analyses beside the VCL curves of
    ``external_baselines`` (approximate digitizations of the paper's
    figures).  Writes ``vcl_overlay_torch.json`` and one figure per dataset,
    ``vcl_overlay_<name>_torch.png``, under ``out_dir``: the minted
    ``vcl_overlay*`` files are never written over."""
    from vargp_tpu_torch.experiments import external_baselines as ext

    os.makedirs(out_dir, exist_ok=True)
    out = {"provenance_vcl": ext.PROVENANCE}
    for name, ours_json, vcl in (("smnist", smnist_json, ext.VCL_SMNIST),
                                 ("pmnist", pmnist_json, ext.VCL_PMNIST)):
        if not os.path.exists(ours_json):
            print(f"[compare_vcl] {name}: {ours_json} missing, skipped")
            continue
        curves = {"VAR-GP (ours, minted)": _avg_after_task(_load_acc_matrix(ours_json))}
        curves.update({f"{k} (paper, approx)": list(map(float, v)) for k, v in vcl.items()})
        plots.draw_or_skip(plots.plot_method_comparison, curves,
                           out_path=os.path.join(out_dir, f"vcl_overlay_{name}_torch.png"))
        out[name] = dict(curves=curves, final={k: v[-1] for k, v in curves.items()},
                         ours_source=ours_json)
    with open(os.path.join(out_dir, VCL_JSON), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps({k: v["final"] for k, v in out.items() if isinstance(v, dict)}))
    return out


def _load_acc_matrix(src) -> np.ndarray:
    """A square accuracy matrix from an array or a .json (its
    ``acc_matrix``, or the list itself), .npy or .csv file."""
    if isinstance(src, str):
        if src.endswith(".json"):
            with open(src) as f:
                d = json.load(f)
            src = d["acc_matrix"] if isinstance(d, dict) else d
        elif src.endswith(".npy"):
            src = np.load(src)
        elif src.endswith(".csv"):
            src = np.loadtxt(src, delimiter=",")
    m = np.asarray(src, dtype=np.float64)
    if m.ndim != 2 or m.shape[0] != m.shape[1]:
        raise ValueError(f"an accuracy matrix must be square, got shape {m.shape}")
    return m
