#!/usr/bin/env python3
"""The host's cost of calling a kernel through its ``vargp_torch::`` operator.

    python3 scripts/op_overhead.py [--calls N]

On one card, times N back-to-back calls of K1 (``sym_gram``) at a tiny
shape (2 x 8 x 8 rows of 4 features: the host, not the card, sets the
pace) four ways, by the host clock around the calls and a final
synchronise, in turns, best of three: the wrapper (the operator as the
port registers it, ``torch.library.Library``'s define and impl, and its
launch); the same launch registered instead with
``torch.library.custom_op`` (under the namespace ``vargp_overhead``, this
script's own); the operator's CUDA implementation called directly (the
launch and its checks, no dispatch); and the same implementation's
ctypes launch alone.  The differences are the dispatch's and the
checks' host microseconds per call, which a training step pays once per
kernel launch (5 at A and D, 7 at E).  The last lines are the card's
name and power limit and one JSON object.
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def per_call_us(fn, calls: int) -> float:
    import torch

    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=20000)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke
    from vargp_tpu_torch.ops.cuda import build
    from vargp_tpu_torch.ops.cuda import sym_gram as K1

    if not torch.cuda.is_available():
        print("op_overhead: no CUDA device available", file=sys.stderr)
        return 1
    build.library()
    dev = torch.device("cuda")
    z = torch.rand(8, 8, 4, device=dev)
    invs, g = torch.ones(2, 4, device=dev), torch.ones(2, device=dev)
    out = torch.empty(2, 8, 8, 8, device=dev)

    @torch.library.custom_op("vargp_overhead::sym_gram", mutates_args=(), device_types="cuda")
    def k1_custom_op(z: torch.Tensor, invs: torch.Tensor, gamma2: torch.Tensor) -> torch.Tensor:
        return K1._cuda(z, invs, gamma2)

    def raw():
        build.launch("vargp_sym_gram", dev, z.data_ptr(), invs.data_ptr(), g.data_ptr(),
                     out.data_ptr(), 2, 8, 8, 4)

    res = {}
    for _ in range(3):  # three times, in turns
        for name, fn in (("wrapper", lambda: K1.sym_gram(z, invs, g)),
                         ("custom_op", lambda: k1_custom_op(z, invs, g)),
                         ("cuda_impl", lambda: K1._cuda(z, invs, g)), ("raw_launch", raw)):
            res.setdefault(name, []).append(per_call_us(fn, args.calls))
    best = {k: min(v) for k, v in res.items()}
    print("  host us per call (best of 3): " + "  ".join(f"{k} {v:.2f}" for k, v in best.items())
          + f"; dispatch: Library {best['wrapper'] - best['cuda_impl']:.2f} us, custom_op "
          f"{best['custom_op'] - best['cuda_impl']:.2f} us")
    print(chip_smoke.nvidia_smi_line())
    print(json.dumps({"calls": args.calls, "us_per_call": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
