"""Hyperparameter sweeps.

Counterpart of ``vargp_tpu/experiments/sweep.py`` (the reference's
experiments/wandb_utils.py:6-44, a W&B random search over VAR-GP's
hyperparameters): the same search space written as a local JSON spec,
submitted to W&B only when asked and ``wandb`` is installed, and a local
random-search runner over the port's drivers.
"""

import inspect
import json
import os

import numpy as np

# the search space of wandb_utils.py:13-38
DEFAULT_SPACE = {
    "method": "random",
    "metric": {"name": "val/acc", "goal": "maximize"},
    "parameters": {
        "lr": {"distribution": "log_uniform_values", "min": 1e-4, "max": 1e-1},
        "beta": {"distribution": "log_uniform_values", "min": 1e-2, "max": 1e2},
        "M": {"values": [20, 40, 60, 80, 100, 150, 200]},
        "batch_size": {"values": [256, 512]},
        "ep_var_mean": {"values": [True, False]},
        "map_est_hypers": {"values": [True, False]},
    },
}


def generate_vargp_sweep(experiment="s_mnist", out=None, submit_wandb=False):
    """Write the sweep spec (``program``: this package's command line) to
    ``out`` (default ``sweep_<experiment>.json``); with ``submit_wandb``
    also hand it to ``wandb.sweep`` where wandb is installed."""
    spec = dict(DEFAULT_SPACE)
    spec["program"] = f"python -m vargp_tpu_torch {experiment}"
    out = out or f"sweep_{experiment}.json"
    with open(out, "w") as f:
        json.dump(spec, f, indent=2)
    print(f"wrote {out}")
    if submit_wandb:
        try:
            import wandb
        except ImportError:
            print("wandb is not installed; local spec only")
            return out
        try:
            print(f"wandb sweep: {wandb.sweep(spec)}")
        except Exception as e:  # offline or not logged in: the local spec stands
            print(f"wandb sweep not submitted ({type(e).__name__}: {e}); local spec only")
    return out


def _sample(space, rng):
    """One configuration drawn from ``space`` with the numpy generator
    ``rng``, parameter by parameter in the space's order."""
    cfg = {}
    for name, p in space["parameters"].items():
        if "values" in p:
            cfg[name] = p["values"][rng.integers(len(p["values"]))]
        elif p.get("distribution") == "log_uniform_values":
            lo, hi = np.log(p["min"]), np.log(p["max"])
            cfg[name] = float(np.exp(rng.uniform(lo, hi)))
    return cfg


def run_sweep(experiment="toy", n_trials=4, seed=0, spec=None, **overrides):
    """Local random search: ``n_trials`` configurations sampled from
    ``spec`` (default ``DEFAULT_SPACE``), each run in this process by the
    port's driver for ``experiment`` (``toy``, ``s_mnist`` or ``p_mnist``)
    with trial t's seed ``seed + t`` and ``overrides`` on top (``device``,
    ``epochs``, ...), into ``$VARGP_TPU_LOGDIR/sweep_<experiment>_<t>``
    (``runs/`` by default).  Sampled keys the driver does not take are
    dropped.  Returns [(score, config)], best first, the score the best
    final-task test accuracy."""
    from vargp_tpu_torch.experiments import vargp_run

    fns = {
        "toy": vargp_run.toy,
        "s_mnist": vargp_run.split_mnist,
        "p_mnist": vargp_run.permuted_mnist,
    }
    fn = fns[experiment]
    space = spec or DEFAULT_SPACE
    rng = np.random.default_rng(seed)
    accepted = set(inspect.signature(fn).parameters)
    results = []
    for trial in range(n_trials):
        cfg = {k: v for k, v in _sample(space, rng).items() if k in accepted}
        cfg.update(overrides)
        if "seed" in cfg:
            raise ValueError(
                "run_sweep assigns per-trial seeds itself (seed+trial); "
                "pass the base via the seed= parameter, not overrides/spec"
            )
        cfg["log_dir"] = os.path.join(os.environ.get("VARGP_TPU_LOGDIR", "runs"),
                                      f"sweep_{experiment}_{trial}")
        print(f"[sweep {trial}] {cfg}")
        _, summaries = fn(seed=seed + trial, **cfg)
        final = summaries[-1] if summaries else {}
        score = max((v for k, v in final.items() if k.endswith("test/acc")), default=0.0)
        results.append((score, cfg))
        print(f"[sweep {trial}] score={score:.4f}")
    results.sort(key=lambda r: -r[0])
    print(f"best: score={results[0][0]:.4f} cfg={results[0][1]}")
    return results
