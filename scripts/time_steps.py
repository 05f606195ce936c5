#!/usr/bin/env python3
"""One training step at A, D and E on one card, by CUDA events.

    python3 scripts/time_steps.py [--root DIR] [--reps N]

Times ``chip_smoke``'s steps with ``chip_smoke.time_ms`` (CUDA events
around ``reps`` back-to-back calls after a warm-up): A, Split-MNIST's
flagship ``elbo_step`` (``chip_smoke.train_inputs("A")``); D, the global
SVGP's step at task 1 of s_mnist_global (``global_inputs``); E, the
Retrain ablation's first step of task 1 (``retrain_inputs``).  ``--root``
names the tree whose ``vargp_tpu_torch`` is timed (default: this one), so
that an unpacked ``git archive`` of another commit is timed by the same
code, in the same call, on the same card: run parent, change, change,
parent.  The last lines are the card's name and power limit and one JSON
object.
"""

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=REPO)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import chip_smoke  # this tree's timing code

    sys.path.insert(0, str(args.root.resolve()))
    import torch

    import vargp_tpu_torch  # noqa: F401  (the timed tree's)

    if not torch.cuda.is_available():
        print("time_steps: no CUDA device available", file=sys.stderr)
        return 1
    print(f"timing {Path(vargp_tpu_torch.__file__).parent}")
    dev = torch.device("cuda")
    a = chip_smoke.train_inputs("A", dev)
    d = chip_smoke.global_inputs("S-MNIST global", dev)
    e = chip_smoke.retrain_inputs(dev, task=1)
    steps = {"A": lambda: chip_smoke.step(a), "D": lambda: chip_smoke.global_step(d),
             "E": lambda: chip_smoke.retrain_step(e)}
    out = {name: chip_smoke.time_ms(fn, reps=args.reps) for name, fn in steps.items()}
    print("  step ms by CUDA events: " + "  ".join(f"{k} {v:.4f}" for k, v in out.items()))
    print(chip_smoke.nvidia_smi_line())
    print(json.dumps({"root": str(args.root), "step_ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
