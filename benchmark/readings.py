"""The readings that the limits of ``limits/<cell>.json`` are set from.

    python3 benchmark/readings.py --workload <cell> --seeds 11 12 ... [--control-seeds ...]
        [--fault-seeds ...] [--seconds 1]

For each seed, in one process on the card, at the cell's own sizes: the
program's numbers against the reference (the cell's set-up, its first
steps or a short window at its own load, and the comparison a run makes);
for each control seed also the control's, the reference computed in TF32
and put in the program's place; for each fault seed each fault that the
cell's kind of work can have (its ``FAULTS``), planted in the program.  One
JSON line per reading.  The benchmark's runs never run this.
"""

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or os.curdir) not in (HERE, ROOT)]

import torch  # noqa: E402

from benchmark import cell as C  # noqa: E402
from benchmark.reference import vargp as R  # noqa: E402


def reading(cell: C.Cell, seed: int, seconds: float, device, fault=None, control=False) -> dict:
    t = time.time()
    mix = C.make_mix(cell, seed, device)
    faults = C.kind(cell.root, cell.traffic["kind"]).FAULTS
    with faults[fault]() if fault else contextlib.nullcontext():
        mix.setup()
        if seconds > 0:
            mix.window(seconds)
    out = mix.program_outputs()
    mix.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = mix.reference(R.F64)
    result = {"seed": seed, "fault": fault, "numbers": mix.numbers(out, ref)}
    if control:
        result["control"] = mix.numbers(mix.reference(R.TF32), ref)
    return dict(result, seconds=round(time.time() - t, 2))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=1.0,
                   help="the short window's length; 0: none (a training cell's readings)")
    args = p.parse_args(argv)
    cell = C.load(ROOT, args.workload)
    device = torch.device("cuda")
    jobs = [dict(seed=s, control=s in args.control_seeds)
            for s in dict.fromkeys(args.seeds + args.control_seeds)]
    jobs += [dict(seed=s, fault=f) for s in args.fault_seeds
             for f in C.kind(cell.root, cell.traffic["kind"]).FAULTS]
    for job in jobs:
        print(json.dumps(dict(reading(cell, seconds=args.seconds, device=device, **job),
                              workload=cell.name)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
