#!/usr/bin/env python3
"""Where the time of vargp_tpu_torch's flagship forward goes, on one card.

    python3 scripts/profile_torch_forward.py

Runs ``loss`` and ``predict`` of the flagship model (the inputs of
``chip_smoke.py``) under ``torch.profiler`` after a warm-up (``predict``
twice: reusing the posterior its first call built, as a pass over a split
does, and with the posterior built each call), and prints:
the wall time per call, the device-busy time per call (the sum of kernel
times; launches do not overlap on one stream), the device idle share, the
number of kernel launches per call, and, for each call, the kernels that
take the most device time.  The per-call tables come first; the last
lines are one summary line per call and one JSON object holding them all.
"""

import json
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the flagship model and its inputs)

REPS = 10


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_forward: no CUDA device available", file=sys.stderr)
        return 1
    from vargp_tpu_torch.models import vargp as V

    print(f"card: {chip_smoke.nvidia_smi_line()}")
    dev = torch.device("cuda")
    cfg, params, prev, prior, x, y, noise, pnoise = chip_smoke.flagship_model(dev)
    calls = {
        "loss": lambda: V.loss(params, prev, prior, x, y, noise, cfg),
        "predict": lambda: V.predict(params, prev, x, pnoise, cfg),
        "predict_built": lambda: (V.clear_posterior_cache(),
                                  V.predict(params, prev, x, pnoise, cfg))[1],
    }
    summary = {}
    for name, fn in calls.items():
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
        summary[name] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                         "idle_share": 1 - busy_ms / wall_ms,
                         "launches": len(kernels) / REPS}
        print(f"== {name}: the kernels by device time, {REPS} calls ==")
        print(prof.key_averages().table(sort_by="device_time_total", row_limit=15))
    for name, m in summary.items():
        print(f"{name}: wall {m['wall_ms']:.4f} ms/call under the profiler, device busy "
              f"{m['device_busy_ms']:.4f} ms/call, idle share {m['idle_share']:.3f}, "
              f"{m['launches']:.1f} kernel launches/call")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
