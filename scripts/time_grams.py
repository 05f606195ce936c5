#!/usr/bin/env python3
"""The Gram kernels (K1, K2, K4, K5) on one card at the shapes the paths
give them.

    python3 scripts/time_grams.py [--root DIR]

Times ``chip_smoke.gram_cases`` (``chip_smoke.GRAM_SHAPES``: K1 at A's
step, the evaluation's predict (H = 20) and P-MNIST's S = 500; K2 at B's
step; K4 at A's and B's steps and the evaluation's; K5's K_zz and K_zx at
C's step and the evaluation's) with ``chip_smoke.kernel_times``, as the
smoke times every kernel: each kernel's device time, its time by CUDA
events and cold, its plain version's and the yardstick's (``cdist`` +
``exp``), the bounds at the 3xTF32 and f32 rates and the effective
TFLOP/s.  ``--root`` names the tree whose ``vargp_tpu_torch`` is timed
(default: this one), so that an unpacked ``git archive`` of another commit
is timed by the same code, in the same call, on the same card.  The last
lines are the card's name and power limit and one JSON object.
"""

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=REPO)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import chip_smoke  # this tree's timing code

    sys.path.insert(0, str(args.root.resolve()))
    import torch

    import vargp_tpu_torch  # noqa: F401  (the timed tree's)

    if not torch.cuda.is_available():
        print("time_grams: no CUDA device available", file=sys.stderr)
        return 1
    print(f"timing {Path(vargp_tpu_torch.__file__).parent}")
    out = {}
    for n, cases in chip_smoke.gram_cases(torch.device("cuda")).items():
        out[n] = {}
        for label, case in cases.items():
            out[n][label] = chip_smoke.kernel_times(**case)
            print(f"  {n} at {label}: {chip_smoke.fmt_times(out[n][label])}")
    print(chip_smoke.nvidia_smi_line())
    print(json.dumps({"root": str(args.root), "grams": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
