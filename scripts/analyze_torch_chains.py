#!/usr/bin/env python3
"""Reload the minted Split-MNIST and Permuted-MNIST chains on one card and
rebuild their analysis matrices with vargp_tpu_torch.

    python3 scripts/analyze_torch_chains.py [--out runs/chains] [--seeds N] [chain ...]

Chains (default: all three): ``results/smnist_dkl`` (the deep kernel),
``results/smnist_r4`` and ``results/pmnist_r4``, all trained on the
synthetic MNIST surrogate, which is made here again from its numpy seed.
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
        fn, kw, n_tasks, M, dkl = CHAINS[name]
        log_dir = REPO / "results" / name
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
