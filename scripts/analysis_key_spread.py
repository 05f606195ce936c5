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

The global SVGP's chains, ``smnist_global`` (``analyze_smnist_global``'s
protocol: row t is ckpt_t alone, one key a cell, about 1 min a run on 4
CPU threads) and ``toy_global_full`` (``analyze_toy_global``'s density
retention), run on the JAX side only: with eval keys 0 .. keys-1 in place
of the JAX analyses' fixed key 0, and nothing written beside the chain.
``smnist_global`` has no minted ``analysis.json``: its deviations are
taken from key 0's matrices (the JAX analysis as it runs), and every run's
matrices are printed; ``toy_global_full``'s from the minted
``toy_density.json``.  ``scripts/analyze_torch_chains.py`` holds the
port's reload on the card to these spreads.

The Retrain ablation's ``toy_retrain_full`` runs on the JAX side only
too: the JAX ``vargp_retrain.predict`` of its ckpt1 (both tasks' chain)
on the toy's 4 classes (200 rows, one 512-row batch) at the model's
budgets (n_var_samples = 3, n_f = 10), key k's draws for run k; each run's
accuracy and mean predictive entropy (nats), then their mean and
standard deviation over the keys.
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


def jax_global_smnist_runs(log_dir, keys):
    """``analyze_smnist_global``'s matrices with eval key k in place of 0."""
    from dataclasses import replace

    import jax
    import jax.numpy as jnp

    from vargp_tpu import data
    from vargp_tpu.models import global_svgp as G
    from vargp_tpu.train.metrics import compute_acc_ent
    from vargp_tpu.utils.checkpoint import load_chain

    cfg = G.GlobalSVGPConfig(M=60, out_size=10, in_size=784)
    template, _ = G.init_params(jax.random.key(0), jnp.zeros((10, 60, 784)), cfg)
    chain = load_chain(log_dir, 5, [template] * 5)
    test_full = data.load_mnist(None, train=False)
    test_sets = [data.filter_by_class(test_full, [2 * t, 2 * t + 1]) for t in range(5)]
    cfg_eval = replace(cfg, n_f=50, n_var_samples=20)
    predict = jax.jit(G.predict, static_argnames="cfg")
    for k in range(keys):
        key = jax.random.key(k)
        acc, ent = np.zeros((5, 5)), np.zeros((5, 5))
        for t in range(5):
            for s, test_set in enumerate(test_sets):
                key, kc = jax.random.split(key)
                a, e = compute_acc_ent(
                    test_set, lambda x: predict(chain[t], None, jnp.asarray(x), kc, cfg=cfg_eval),
                    batch_size=512)
                acc[t, s], ent[t, s] = a, e / np.log(10)
        yield acc, ent


def jax_global_toy_runs(log_dir, keys):
    """``analyze_toy_global``'s density retention with eval key k in place
    of 0 (the grid's draws split off and unused, as there)."""
    from dataclasses import replace

    import jax
    import jax.numpy as jnp

    from vargp_tpu import data
    from vargp_tpu.models import global_svgp as G
    from vargp_tpu.utils.checkpoint import load_chain

    cfgs = [G.GlobalSVGPConfig(M=20 * (t + 1), out_size=4, in_size=2) for t in range(2)]
    templates = [G.init_params(jax.random.key(0), jnp.zeros((4, c.M, 2)), c)[0] for c in cfgs]
    chain = load_chain(log_dir, 2, templates)
    task0 = data.filter_by_class(data.make_toy_dataset(seed=0), [0, 1])
    for k in range(keys):
        key = jax.random.key(k)
        ret = []
        for t, params in enumerate(chain):
            key, _, k_ret = jax.random.split(key, 3)
            p0 = np.asarray(G.predict(params, None, jnp.asarray(task0.data), k_ret,
                                      replace(cfgs[t], n_f=50, n_var_samples=20)))
            ret.append(float(np.mean(p0[np.arange(len(task0)), task0.targets])))
        yield ret


def jax_retrain_toy_runs(log_dir, keys):
    """(accuracy, mean entropy in nats) of the Retrain chain's ckpt1 on the
    toy's 4 classes with predict key k in 0 .. keys-1."""
    import jax
    import jax.numpy as jnp

    from vargp_tpu import data
    from vargp_tpu.models import vargp_retrain as R
    from vargp_tpu.train.metrics import compute_acc_ent
    from vargp_tpu.utils.checkpoint import load_pytree

    cfg = R.RetrainConfig(M=20, out_size=4, in_size=2)
    task = R.TaskRaw(jnp.zeros((4, 20, 2)), jnp.zeros((4, 20, 1)), jnp.zeros((4, 210)))
    template = R.RetrainParams((task, task), R.RBFParams(jnp.zeros(3), jnp.zeros(3)))
    params = jax.tree_util.tree_map(jnp.asarray, load_pytree(f"{log_dir}/ckpt1.npz", template))
    toy = data.make_toy_dataset(seed=0)
    predict = jax.jit(R.predict, static_argnames="cfg")
    for k in range(keys):
        key = jax.random.key(k)
        yield compute_acc_ent(toy, lambda x: predict(params, jnp.asarray(x), key, cfg=cfg), 512)


def global_spread(name, keys) -> dict:
    log_dir = str(REPO / "results" / name)
    t0 = time.perf_counter()
    if name == "toy_retrain_full":
        runs = [list(r) for r in jax_retrain_toy_runs(log_dir, keys)]
        for k, (acc, ent) in enumerate(runs):
            print(f"{name} jax key {k}: accuracy {acc!r} mean entropy {ent!r}", flush=True)
        arr = np.asarray(runs)
        return {"runs": runs, "mean": arr.mean(axis=0).tolist(), "std": arr.std(axis=0).tolist(),
                "min": arr.min(axis=0).tolist(), "max": arr.max(axis=0).tolist(),
                "seconds_per_run": (time.perf_counter() - t0) / keys}
    if name == "toy_global_full":
        minted = json.loads((REPO / "results" / name / "toy_density.json").read_text())
        runs = list(jax_global_toy_runs(log_dir, keys))
        for k, r in enumerate(runs):
            print(f"{name} jax key {k}: density retention {r}", flush=True)
        arr = np.asarray(runs)
        return {"runs": runs, "minted": minted["density_retention"],
                "retention_range": [arr.min(axis=0).tolist(), arr.max(axis=0).tolist()],
                "seconds_per_run": (time.perf_counter() - t0) / keys}
    runs = []
    for k, (acc, ent) in enumerate(jax_global_smnist_runs(log_dir, keys)):
        runs.append({"acc_matrix": acc.tolist(), "ent_matrix": ent.tolist(),
                     "final_avg_acc": float(acc[-1].mean())})
        print(f"{name} jax key {k}: final avg acc {runs[-1]['final_avg_acc']:.4f}  acc matrix "
              f"{np.round(acc, 4).tolist()}", flush=True)
    ref = runs[0]
    for r in runs:
        r.update(_deviation(np.asarray(r["acc_matrix"]), np.asarray(r["ent_matrix"]), ref))
    acc = np.asarray([r["acc_matrix"] for r in runs])
    return {"runs": runs, "max_dacc": max(r["max_dacc"] for r in runs),
            "max_dent": max(r["max_dent"] for r in runs),
            "final_avg_acc_range": [min(r["final_avg_acc"] for r in runs),
                                    max(r["final_avg_acc"] for r in runs)],
            "acc_min": acc.min(axis=0).tolist(), "acc_max": acc.max(axis=0).tolist(),
            "seconds_per_run": (time.perf_counter() - t0) / keys}


GLOBAL_CHAINS = ("smnist_global", "toy_global_full", "toy_retrain_full")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--keys", type=int, default=8)
    ap.add_argument("--side", choices=("both", "jax", "port"), default="both")
    ap.add_argument("chains", nargs="*", default=["sdigits_r4", "sdigits_dkl"])
    args = ap.parse_args()
    out = {}
    for name in args.chains:
        if name in GLOBAL_CHAINS:
            out[f"{name} jax"] = global_spread(name, args.keys)
            continue
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
