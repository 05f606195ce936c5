#!/usr/bin/env python3
"""Reload the minted Split-MNIST and Permuted-MNIST chains on one card and
rebuild their analysis matrices with vargp_tpu_torch.

    python3 scripts/analyze_torch_chains.py [--out runs/chains] [--seeds N]
        [--results DIR] [chain ...]

Chains (default: the three VAR-GP ones): ``results/smnist_dkl`` (the deep
kernel), ``results/smnist_r4`` and ``results/pmnist_r4``, all trained on
the synthetic MNIST surrogate, which is made here again from its numpy
seed; and the global SVGP's ``smnist_global`` (``analyze_smnist_global``,
held to the JAX analysis's spread over 8 evaluation keys, GLOBAL_SPREAD)
and ``toy_global_full`` (``analyze_toy_global``'s density retention, held
to the JAX spread over 12 keys); and the Retrain ablation's
``toy_retrain_full`` (its ckpt1's accuracy and mean entropy on the toy's 4
classes at the model's budgets, one draw a seed, held to the JAX
``predict``'s spread over 12 keys, RETRAIN_SPREAD).  ``--results`` reads the chains from
another directory (the chip copy leaves out most of ``results/``: copy the
global chains under ``runs/``, which travels).
For each, the port's ``analyze_smnist`` / ``analyze_pmnist`` runs on the
card at the notebooks' budgets (n_f = 50, n_var_samples = 20) and writes
``<out>/<chain>/analysis_torch.json`` (the minted ``analysis.json`` is only
read).  Printed per chain: the largest per-cell deviation of the accuracy
and entropy matrices from the minted ones, the final average accuracy and
BWT beside the minted ones, the wall time of the analysis, and the time
of one ``predict`` at H = 20 on a 512-row batch with the whole chain (its
largest S), CUDA-synchronised host clock over 10 calls after 2.  With
``--seeds N`` the analysis runs again with the evaluation generator's
seeds 1 .. N-1, and the spread of the N runs is printed beside the minted
values: the range of the final average accuracy and the largest per-cell
deviation from the minted matrices over the runs.  The card's name and
power limit come first; the last line is one JSON object with every
figure.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# name: (analysis function, its arguments, tasks, M, dkl)
CHAINS = {
    "smnist_dkl": ("analyze_smnist", dict(M=60, dkl=True), 5, 60, True),
    "smnist_r4": ("analyze_smnist", dict(M=60), 5, 60, False),
    "pmnist_r4": ("analyze_pmnist", dict(M=100, n_tasks=10, perm_seed=1), 10, 100, False),
}
N_F, N_VAR, B = 50, 20, 512
# The JAX analyses' spread over their evaluation noise
# (``scripts/analysis_key_spread.py --keys 8 smnist_global`` and ``--keys 12
# toy_global_full``, on the CPU): per cell of smnist_global's accuracy and
# entropy matrices, and of its final average accuracy, the mean and the
# standard deviation over keys 0-7 (it has no minted analysis.json); of
# toy_global_full's task-0 density retention after each task, the range,
# mean and standard deviation over keys 0-11 (key 0 is the minted
# toy_density.json).  The port's analysis is one more draw of the same
# noise: it is held to each mean within 3 standard deviations (a cell with
# no spread, within 0.002).  (One more draw lands outside the range of 12
# with probability 2/13 a task; 8 keys' largest deviation from key 0 was
# 0.0778 in accuracy, at cell (4, 3), whose keys spread over 0.817-0.907.)
GLOBAL_SPREAD = {
    "smnist_global": dict(
        acc_mean=[
            [1.0, 0.0, 0.0, 0.0, 0.0],
            [0.93837, 0.99804, 0.0, 0.0, 0.0],
            [0.75697, 0.95998, 0.99949, 0.0, 0.0],
            [0.81356, 0.90506, 0.89354, 0.99834, 0.0],
            [0.80154, 0.87634, 0.51504, 0.87218, 0.99982]],
        acc_std=[
            [0.0, 0.0, 0.0, 0.0, 0.0],
            [0.0006916, 0.0, 0.0, 0.0, 0.0],
            [0.0057093, 0.0030291, 1.1869e-16, 0.0, 0.0],
            [0.004879, 0.0038285, 0.015189, 0.00045387, 0.0],
            [0.006076, 0.0053732, 0.0080818, 0.032991, 0.00025482]],
        ent_mean=[
            [0.19943, 0.9248, 0.92331, 0.92266, 0.93106],
            [0.51715, 0.077521, 0.68214, 0.7995, 0.76376],
            [0.70518, 0.22599, 0.058801, 0.75771, 0.75235],
            [0.77153, 0.49628, 0.28905, 0.038247, 0.7541],
            [0.81794, 0.63025, 0.49811, 0.23774, 0.028782]],
        ent_std=[
            [0.011721, 0.0055039, 0.0044915, 0.003677, 0.0047912],
            [0.01389, 0.0042476, 0.014637, 0.007692, 0.0092719],
            [0.0076024, 0.014053, 0.0057998, 0.010861, 0.011185],
            [0.005848, 0.010907, 0.012728, 0.0092922, 0.012611],
            [0.005513, 0.013268, 0.014909, 0.010529, 0.0047475]],
        final_avg_acc=(0.8129845540515149, 0.006863109009271213)),
    "toy_global_full": dict(retention=((0.5239404439926147, 0.4380895495414734),
                                       (0.5428863167762756, 0.4541010558605194)),
                            mean=(0.5314304331938425, 0.44777121643225354),
                            std=(0.005609089092176997, 0.004252813374806407),
                            minted=(0.5257651209831238, 0.4466162621974945)),
}
SPREAD_FLOOR = 0.002
# ``scripts/analysis_key_spread.py --keys 12 toy_retrain_full`` on the CPU:
# the JAX ``vargp_retrain.predict`` of ckpt1 on the toy's 200 rows (one
# 512-row batch) at n_var_samples = 3, n_f = 10, keys 0-11: (mean, std,
# min, max) of the accuracy and of the mean entropy in nats.
RETRAIN_SPREAD = {"toy_retrain_full": dict(acc=(0.6375, 0.02479079130107255, 0.59, 0.665),
                                           ent=(1.0068968391418458, 0.04712570347498606,
                                                0.9533758544921875, 1.1158587646484375))}


def _within(got, mean, std) -> np.ndarray:
    """|got - mean| <= 3 std (SPREAD_FLOOR where std is 0), elementwise."""
    mean, std = np.asarray(mean), np.asarray(std)
    return np.abs(np.asarray(got) - mean) <= np.maximum(3 * std, SPREAD_FLOOR)


def global_chain(name: str, log_dir: Path, out: Path, seeds: int) -> dict:
    """A global chain's analysis on the card against GLOBAL_SPREAD, over
    the port's evaluation seeds 0 .. seeds-1; each run's outputs are
    written under ``out``, never beside the minted chain."""
    import shutil

    from vargp_tpu_torch.experiments import analysis as A

    spread = GLOBAL_SPREAD[name]
    work = out / name
    work.mkdir(parents=True, exist_ok=True)
    for f in log_dir.glob("ckpt*.npz*"):
        shutil.copy(f, work / f.name)
    runs, walls = [], []
    for k in range(seeds):
        t0 = time.perf_counter()
        if name == "toy_global_full":
            runs.append(A.analyze_toy_global(str(work), seed=k, out_json=str(
                work / f"toy_density_torch_seed{k}.json")))
        else:
            runs.append(A.analyze_smnist_global(str(work), seed=k, out_json=str(
                work / f"analysis_torch_seed{k}.json")))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    row = {"wall_s": walls}
    if name == "toy_global_full":
        lo, hi = (np.asarray(v) for v in spread["retention"])
        mean, std = np.asarray(spread["mean"]), np.asarray(spread["std"])
        ret = np.asarray([r["density_retention"] for r in runs])
        row.update(retention=ret.tolist(), jax_range=[lo.tolist(), hi.tolist()],
                   in_range=bool(np.all((lo <= ret) & (ret <= hi))),
                   inside=bool(np.all(np.abs(ret - mean) <= 3 * std)))
        print(f"{name}: density retention per seed {ret.tolist()} (JAX over 12 keys: task 0 "
              f"{lo[0]:.4f}-{hi[0]:.4f}, task 1 {lo[1]:.4f}-{hi[1]:.4f}, mean {mean.tolist()}, "
              f"std {std.tolist()}; minted {spread['minted']}); within 3 std of the mean: "
              f"{row['inside']}, inside the range: {row['in_range']}", flush=True)
        return row
    acc = np.asarray([r["acc_matrix"] for r in runs])
    ent = np.asarray([r["ent_matrix"] for r in runs])
    finals = [r["final_avg_acc"] for r in runs]
    ok_acc = _within(acc, spread["acc_mean"], spread["acc_std"])
    ok_ent = _within(ent, spread["ent_mean"], spread["ent_std"])
    fm, fs = spread["final_avg_acc"]
    ok_final = _within(finals, fm, fs)
    row.update(final_avg_acc=finals, bwt=[r["bwt"] for r in runs],
               acc_matrix=acc[0].tolist(), ent_matrix=ent[0].tolist(),
               cells_outside_acc=int((~ok_acc).sum()), cells_outside_ent=int((~ok_ent).sum()),
               inside=bool(ok_acc.all() and ok_ent.all() and ok_final.all()),
               predict_ms_H20=predict_ms_global(work))
    print(f"{name}: final avg acc {finals} (JAX {fm:.4f} +- {fs:.4f})  BWT {row['bwt']}; cells "
          f"outside 3 std: accuracy {row['cells_outside_acc']}, entropy "
          f"{row['cells_outside_ent']} of {acc.size}; inside: {row['inside']}; predict at "
          f"H=20 {row['predict_ms_H20']:.3f} ms", flush=True)
    print(f"  acc matrix (seed 0): {np.round(acc[0], 4).tolist()}")
    print(f"  ent matrix (seed 0): {np.round(ent[0], 4).tolist()}")
    return row


def retrain_chain(name: str, log_dir: Path, seeds: int) -> dict:
    """The Retrain chain's ckpt1 reloaded on the card: its accuracy and mean
    entropy (nats) on the toy's 4 classes at the model's budgets, on the
    draws of generator seeds 0 .. seeds-1 (hyper samples, then function
    samples, one set for the batch), each held to RETRAIN_SPREAD's mean
    within 3 standard deviations."""
    from vargp_tpu_torch import data
    from vargp_tpu_torch.models import vargp_retrain as R
    from vargp_tpu_torch.train.metrics import compute_acc_ent
    from vargp_tpu_torch.utils.checkpoint import load_pytree
    from vargp_tpu_torch.utils.convert import params_from_numpy

    dev = torch.device("cuda")
    cfg = R.RetrainConfig(M=20, out_size=4, in_size=2)
    tree = load_pytree(str(log_dir / "ckpt1.npz"), R.params_template(cfg, 2))
    params = params_from_numpy(tree, device=dev)[0]
    toy = data.make_toy_dataset(seed=0)
    runs = []
    for k in range(seeds):
        gen = torch.Generator(device=dev).manual_seed(k)
        noise = {"hyper_eps": torch.randn((3, 3), generator=gen, device=dev),
                 "lik_eps": torch.randn((3, 10, 4, B), generator=gen, device=dev)}

        def predict(x):
            with torch.no_grad():
                return R.predict(params, torch.from_numpy(x).to(dev), noise, cfg, device=dev)

        runs.append(compute_acc_ent(toy, predict, B))
    spread = RETRAIN_SPREAD[name]
    arr = np.asarray(runs)
    inside = bool(all(_within(arr[:, i], spread[key][0], spread[key][1]).all()
                      for i, key in enumerate(("acc", "ent"))))
    print(f"{name}: ckpt1 on the toy's 4 classes, per seed (accuracy, mean entropy) "
          f"{arr.tolist()}; JAX over 12 keys: accuracy {spread['acc'][0]:.4f} +- "
          f"{spread['acc'][1]:.4f}, entropy {spread['ent'][0]:.4f} +- {spread['ent'][1]:.4f}; "
          f"within 3 std of the means: {inside}", flush=True)
    return {"runs": arr.tolist(), "jax": spread, "inside": inside}


def predict_ms_global(log_dir: Path) -> float:
    """ms per predict of the global chain's last task at the analysis
    budgets on one 512-row batch (CUDA-synchronised host clock, 10 calls
    after 2)."""
    from vargp_tpu_torch import data
    from vargp_tpu_torch.experiments import analysis as A
    from vargp_tpu_torch.models import global_svgp as G

    dev = torch.device("cuda")
    cfg = G.GlobalSVGPConfig(M=60, out_size=10, in_size=784)
    params = A.load_global_chain(str(log_dir), [cfg] * 5, device=dev)[-1]
    cfg_eval = G.eval_budget_cfg(cfg, n_f=N_F, n_var_samples=N_VAR)
    noise = next(A.eval_draws(torch.Generator(device=dev).manual_seed(0), cfg_eval, 1, B))
    x = torch.from_numpy(data.load_mnist(None, train=False).data[:B]).to(dev)

    def call():
        with torch.no_grad():
            return G.predict(params, None, x, noise, cfg_eval, device=dev)

    for _ in range(2):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / 10 * 1e3


def predict_ms(log_dir: Path, n_tasks: int, M: int, dkl: bool) -> float:
    """ms per predict of the last row's model (the whole chain) on one
    batch at the analysis budgets."""
    from vargp_tpu_torch import data
    from vargp_tpu_torch.experiments import analysis as A
    from vargp_tpu_torch.models import vargp as V

    dev = torch.device("cuda")
    cfg = V.VARGPConfig(M=M, out_size=10, in_size=784, dkl=dkl)
    chain = A.load_task_chain(str(log_dir), n_tasks, cfg, device=dev)
    prev, mask = V.pad_chain(tuple(V.freeze_task(p) for p in chain[:-1]), cfg, n_tasks, device=dev)
    cfg_eval = V.eval_budget_cfg(cfg, n_f=N_F, n_var_samples=N_VAR)
    noise = next(A.eval_draws(torch.Generator(device=dev).manual_seed(0), cfg_eval, 1, B))
    x = torch.from_numpy(data.load_mnist(None, train=False).data[:B]).to(dev)

    def call():
        with torch.no_grad():
            return V.predict(chain[-1], prev, x, noise, cfg_eval, chain_mask=mask, device=dev)

    for _ in range(2):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / 10 * 1e3


def spread(runs, minted) -> dict:
    """The runs' spread beside the minted matrices."""
    out = {"final_avg_acc_range": [min(r["final_avg_acc"] for r in runs),
                                   max(r["final_avg_acc"] for r in runs)]}
    for key in ("acc_matrix", "ent_matrix"):
        m = np.asarray([r[key] for r in runs])
        want = np.asarray(minted[key])
        out[f"max_d{key[:3]}"] = float(np.max(np.abs(m - want)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(REPO / "runs" / "chains"))
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--results", default=str(REPO / "results"))
    ap.add_argument("chains", nargs="*", default=list(CHAINS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("analyze_torch_chains: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}")
    from vargp_tpu_torch.experiments import analysis as A
    from vargp_tpu_torch.ops.cuda import build

    build.library()
    summary = {"card": smi}
    for name in args.chains:
        if name in RETRAIN_SPREAD:
            summary[name] = retrain_chain(name, Path(args.results) / name, max(args.seeds, 12))
            continue
        if name in GLOBAL_SPREAD:
            summary[name] = global_chain(name, Path(args.results) / name, Path(args.out),
                                         args.seeds)
            continue
        fn, kw, n_tasks, M, dkl = CHAINS[name]
        log_dir = Path(args.results) / name
        minted = json.loads((log_dir / "analysis.json").read_text())
        out_json = Path(args.out) / name / A.OUT_NAME
        t0 = time.perf_counter()
        got = getattr(A, fn)(str(log_dir), out_json=str(out_json), n_f=N_F, n_var_samples=N_VAR,
                             **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        row = {
            "max_dacc": float(np.max(np.abs(np.subtract(got["acc_matrix"], minted["acc_matrix"])))),
            "max_dent": float(np.max(np.abs(np.subtract(got["ent_matrix"], minted["ent_matrix"])))),
            "final_avg_acc": got["final_avg_acc"], "minted_final_avg_acc": minted["final_avg_acc"],
            "bwt": got["bwt"], "minted_bwt": minted["bwt"],
            "wall_s": wall, "predict_ms_H20": predict_ms(log_dir, n_tasks, M, dkl),
        }
        summary[name] = row
        print(f"{name}: max |dacc| {row['max_dacc']:.4f}  max |dent| {row['max_dent']:.4f}  "
              f"final avg acc {row['final_avg_acc']:.4f} (minted {row['minted_final_avg_acc']:.4f})  "
              f"BWT {row['bwt']:.4f} (minted {row['minted_bwt']:.4f})  wall {wall:.1f} s  "
              f"predict at H=20 {row['predict_ms_H20']:.3f} ms", flush=True)
        print(f"  acc matrix: {np.round(got['acc_matrix'], 4).tolist()}")
        print(f"  ent matrix: {np.round(got['ent_matrix'], 4).tolist()}")
        if args.seeds > 1:
            runs = [got] + [getattr(A, fn)(str(log_dir), out_json=str(out_json.with_name(
                f"analysis_torch_seed{k}.json")), n_f=N_F, n_var_samples=N_VAR, seed=k, **kw)
                for k in range(1, args.seeds)]
            row["seeds"] = spread(runs, minted)
            print(f"  over seeds 0-{args.seeds - 1}: {row['seeds']}", flush=True)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
