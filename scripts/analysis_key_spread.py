#!/usr/bin/env python3
"""Spread of the chain-reload analysis over its evaluation noise, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/analysis_key_spread.py [--keys 8] [--side both] [chain ...]

For each chain (default the Split-Digits ones, ``results/sdigits_r4`` and
``results/sdigits_dkl``; also ``smnist_r4`` and ``smnist_dkl``, on the
synthetic MNIST test splits, about 1.5 min per run), runs the JAX
package's ``accuracy_entropy_matrices`` with eval keys 0 .. keys-1
and/or the port's (``vargp_tpu_torch.experiments.analysis``) with
generator seeds 0 .. keys-1, both at the notebooks' budgets (n_f = 50,
n_var_samples = 20), and prints, per run, the largest per-cell deviation
of the accuracy and entropy matrices from the minted ``analysis.json``
and the final average accuracy; then one JSON object with every run.  The JAX
figures set the tolerance of the port's level-2 test
(``tests/test_torch_analysis.py``).
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# name: (M, in_size, dkl)
CHAINS = {"sdigits_r4": (20, 64, False), "sdigits_dkl": (20, 64, True),
          "smnist_r4": (60, 784, False), "smnist_dkl": (60, 784, True)}


def _deviation(acc, ent, minted):
    return {
        "max_dacc": float(np.max(np.abs(acc - np.asarray(minted["acc_matrix"])))),
        "max_dent": float(np.max(np.abs(ent - np.asarray(minted["ent_matrix"])))),
        "final_avg_acc": float(acc[-1].mean()),
    }


def _test_full(data, D):
    return data.load_digits_dataset(train=False, seed=0) if D == 64 else data.load_mnist(
        None, train=False)


def jax_runs(log_dir, chain_cfg, keys):
    import jax
    import jax.numpy as jnp

    from vargp_tpu import data
    from vargp_tpu.experiments.analysis import accuracy_entropy_matrices, load_task_chain
    from vargp_tpu.models import vargp as JV

    M, D, dkl = chain_cfg
    cfg = JV.VARGPConfig(M=M, out_size=10, in_size=D, dkl=dkl)
    example, _ = JV.init_params(jax.random.key(0), jnp.zeros((10, M, D)), cfg)
    chain = load_task_chain(log_dir, 5, example)
    test_full = _test_full(data, D)
    test_sets = [data.filter_by_class(test_full, [2 * t, 2 * t + 1]) for t in range(5)]
    for k in range(keys):
        yield accuracy_entropy_matrices(chain, cfg, test_sets, key=jax.random.key(k))


def port_runs(log_dir, chain_cfg, keys):
    from vargp_tpu_torch import data
    from vargp_tpu_torch.experiments import analysis as A
    from vargp_tpu_torch.models import vargp as TV

    M, D, dkl = chain_cfg
    cfg = TV.VARGPConfig(M=M, out_size=10, in_size=D, dkl=dkl)
    chain = A.load_task_chain(log_dir, 5, cfg, device="cpu")
    test_full = _test_full(data, D)
    test_sets = [data.filter_by_class(test_full, [2 * t, 2 * t + 1]) for t in range(5)]
    for k in range(keys):
        yield A.accuracy_entropy_matrices(chain, cfg, test_sets, seed=k, device="cpu")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--keys", type=int, default=8)
    ap.add_argument("--side", choices=("both", "jax", "port"), default="both")
    ap.add_argument("chains", nargs="*", default=["sdigits_r4", "sdigits_dkl"])
    args = ap.parse_args()
    out = {}
    for name in args.chains:
        log_dir = REPO / "results" / name
        minted = json.loads((log_dir / "analysis.json").read_text())
        for side, runs in (("jax", jax_runs), ("port", port_runs)):
            if args.side not in ("both", side):
                continue
            rows = []
            t0 = time.perf_counter()
            for k, (acc, ent) in enumerate(runs(str(log_dir), CHAINS[name], args.keys)):
                d = _deviation(acc, ent, minted)
                rows.append(d)
                print(f"{name} {side} key {k}: max |dacc| {d['max_dacc']:.4f}  max |dent| "
                      f"{d['max_dent']:.4f}  final avg acc {d['final_avg_acc']:.4f}", flush=True)
            out[f"{name} {side}"] = {
                "runs": rows,
                "max_dacc": max(r["max_dacc"] for r in rows),
                "max_dent": max(r["max_dent"] for r in rows),
                "final_avg_acc_range": [min(r["final_avg_acc"] for r in rows),
                                        max(r["final_avg_acc"] for r in rows)],
                "minted_final_avg_acc": minted["final_avg_acc"],
                "seconds_per_run": (time.perf_counter() - t0) / args.keys,
            }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
