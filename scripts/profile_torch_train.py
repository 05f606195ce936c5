#!/usr/bin/env python3
"""Where the time of a vargp_tpu_torch training step goes, on one card.

    python3 scripts/profile_torch_train.py [--route default|solve|fused]

The route is the factorisation's (``chip_smoke.ROUTES``): ``default`` (K3
plus products, the whitened-factored posterior), ``solve``
(``solve_via_inverse=False``: K7, then triangular solves) or ``fused``
(``VARGP_TPU_CHOLINV=pallas``: K6 in place of the blocked forward).
For each training configuration of ``chip_smoke.py`` (A: Split-MNIST's
flagship step, S=300; B: Permuted-MNIST's final task, S=1000; C: A under
the deep kernel, phi = 784-256-256-64) it runs,
after a warm-up and under ``torch.profiler``: the ELBO forward alone (no
graph), the forward with the backward (every parameter's gradient), and
the whole ``elbo_step`` (forward, backward, Yogi update).  For each it
prints the wall time per call, the device-busy time per call (the sum of
kernel times; launches do not overlap on one stream), the device idle
share, the kernel launches per call and, for the step, the kernels that
take the most device time.  The last lines are one summary line per call
and one JSON object holding them all.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the training configurations and their inputs)

REPS = 5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--route", choices=("default", "solve", "fused"), default="default")
    route = ap.parse_args().route
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device available", file=sys.stderr)
        return 1
    from vargp_tpu_torch.models import vargp as V

    print(f"card: {chip_smoke.nvidia_smi_line()}; route {route}")
    dev = torch.device("cuda")
    summary = {}
    for cfg_name in chip_smoke.TRAIN:
        t = chip_smoke.train_inputs(cfg_name, dev, route)

        def forward():
            with torch.no_grad():
                return V.loss(t["params"], t["prev"], t["prior"], t["x"], t["y"], t["noise"],
                              t["cfg"], weights=t["w"], chain_mask=t["mask"], device=dev)

        calls = {
            "forward": forward,
            "forward_backward": lambda: chip_smoke.elbo_grads(t),
            "step": lambda: chip_smoke.step(t),
        }
        for name, fn in calls.items():
            with chip_smoke.route_env(route):
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    for _ in range(REPS):
                        fn()
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t0) / REPS * 1e3
            kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / REPS
            key = f"{cfg_name} {name} ({route})"
            summary[key] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                            "idle_share": 1 - busy_ms / wall_ms,
                            "launches": len(kernels) / REPS}
            if name == "step":
                print(f"== {key}: the kernels by device time, {REPS} calls ==")
                print(prof.key_averages().table(sort_by="device_time_total", row_limit=20))
    for key, m in summary.items():
        print(f"{key}: wall {m['wall_ms']:.4f} ms/call under the profiler, device busy "
              f"{m['device_busy_ms']:.4f} ms/call, idle share {m['idle_share']:.3f}, "
              f"{m['launches']:.1f} kernel launches/call")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
