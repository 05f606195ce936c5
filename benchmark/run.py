"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process, one card.  It builds the cell's inputs on the card from the
seed (``inputs.py``), warms up the cell's own shapes, drives the program
(``vargp_tpu_torch``, the PyTorch and CUDA port) for ``--seconds`` through
the cell's traffic mix (``kinds/<kind>.py``), and prints one JSON line last on
standard output.  With ``--trace 0`` the metrics are the cell's end-to-end
metrics; with ``--trace 1`` the window is followed by a short slice under
``torch.profiler`` whose events the cell's per-layer metrics read.  Then
the program's state is freed and the plain reference (``reference/``)
decides ``correct`` (``check.py``); each number compared is printed beside
its limit, last on standard error and last in the result line.

No card, or fewer than the cell asks for: exit 2, no result.  ``jax``,
``jaxlib``, ``flax`` or the JAX package ``vargp_tpu`` loaded in this
process (by whole top-level name): exit 3, no result.
"""

import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root on the path, and not this directory, whose module
# names (trace, ...) would hide the standard library's
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or os.curdir) not in (HERE, ROOT)]

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402

import torch  # noqa: E402

from benchmark import cell as C  # noqa: E402
from benchmark import check, port, trace  # noqa: E402
from benchmark.reference import vargp as R  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "vargp_tpu")


def forbidden_modules() -> list:
    """The forbidden top-level names among the loaded modules, each
    module's name up to its first dot compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def _profiled(mix, device, activities, **kw):
    """Run the mix's traced slice under ``torch.profiler``; the slice read
    from its events."""
    from torch.profiler import profile

    port.sync(device)
    with profile(activities=activities, **kw) as prof:
        t0 = time.time_ns()
        units = mix.traced()
        port.sync(device)
        t1 = time.time_ns()
    return trace.read_slice(prof, t0, t1, units)


def traced_metrics(cell: C.Cell, mix, device) -> tuple:
    """Run the traced slices; (per-layer metrics, busy_s, window_s,
    breakdown).  The first slice traces the card alone (its events and
    the runtime calls), which costs the host little: the idle share, the
    launches and the device times come from it.  The second traces the
    host's ops too, with their input shapes, which slows the host several
    times over: only the operators' calls and the device time of what each
    launched, which the host's pace does not change, come from it."""
    from torch.profiler import ProfilerActivity

    sl = _profiled(mix, device, [ProfilerActivity.CUDA])
    ops = _profiled(mix, device, [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                    record_shapes=True)
    ctx = C.Context(slice=sl, ops_slice=ops, rate=mix.rate, unit_flops=mix.unit_flops(),
                    config=cell.config, traffic=cell.traffic)
    metrics = {}
    for m in cell.per_layer:
        value = C.reader(cell.root, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    breakdown = {"device_ops": trace.device_ops(sl), "idle_gaps": trace.idle_gaps(sl)}
    return metrics, trace.busy_s(sl), sl.seconds, breakdown


def run_cell(cell: C.Cell, seed: int, seconds: float, traced: bool, device: torch.device,
             t_start: float) -> tuple:
    """One run; returns (the result's dict, the lines of the numbers
    compared)."""
    marks = [("imports, the cell", time.time())]
    torch.zeros(1, device=device)
    port.sync(device)
    marks.append(("the card's start", time.time()))
    port.port_modules()
    marks.append(("the port's import", time.time()))
    mix = C.make_mix(cell, seed, device)
    mix.setup()
    port.sync(device)
    marks.append(("inputs, kernels' load or build, warm-up", time.time()))
    setup_s = marks[-1][1] - t_start
    ends = [t_start] + [t for _, t in marks]
    print("setup: " + ", ".join(f"{name} {b - a:.3f} s" for (name, _), a, b
                                in zip(marks, ends, ends[1:])), file=sys.stderr)
    win = mix.window(seconds)
    print(f"window: {win['detail']}", file=sys.stderr)
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": cell.chips}
    breakdown = None
    if traced:
        metrics, busy, window_s, breakdown = traced_metrics(cell, mix, device)
        dev_info.update(busy_s=busy, window_s=window_s)
    else:
        # an end-to-end metric's name up to its first dot is what the kind
        # measures; what follows names the cells that share its bound
        measured = dict(win["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": measured[m["name"].split(".", 1)[0]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev_info["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                     if device.type == "cuda" else 0)
    out = mix.program_outputs()
    mix.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = mix.numbers(out, mix.reference(R.F64))
    correct = check.verdict(numbers, cell.limits) and win["failed"] == 0
    result = {"correct": correct, "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()}
    return result, check.lines(numbers, cell.limits)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = C.load(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); {n} visible", file=sys.stderr)
        return 2
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda"), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in the benchmark's process: {bad}", file=sys.stderr)
        return 3
    # after the window, so that set-up does not count it
    print(power_line(), file=sys.stderr)
    sys.stderr.write("".join(line + "\n" for line in lines))
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
