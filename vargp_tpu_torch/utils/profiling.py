"""Device-time profiling: ``torch.profiler`` traces parsed into per-op times.

Counterpart of ``vargp_tpu/utils/profiling.py``.  On the card a host clock
around launches measures the host's enqueueing as much as the card's
work; the profiler's trace of the device's kernels is what the card did.
``device_trace`` wraps ``torch.profiler`` (CPU and CUDA activities on the
card) and exports a chrome trace; ``parse_trace`` reads it back into
device ms per kernel name, counting the device's kernel events only:
copies and fills under their own names (``Memcpy ...``, ``Memset ...``),
and none of the host's rows (CPU ops, Python functions, CUDA runtime
calls), as the JAX version counts the device's "XLA Ops" row alone.
``profile_fn`` times ``iters`` calls of a function after a warm-up; on the
CPU (``device="cpu"``) it profiles the CPU ops instead, by their own time
(a parent op's time less its children's), which is what the CPU tests run.
"""

import collections
import glob
import gzip
import json
import os
import tempfile
from contextlib import contextmanager

import torch

from vargp_tpu_torch.ops.device import resolve_device

# the chrome trace's categories of device work: kernels, copies, fills
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_NAME = "trace.json"


@contextmanager
def device_trace(log_dir: str | None = None, *, device=None):
    """Profile the block on ``device`` (None means the card): CPU and CUDA
    activities on the card, CPU alone on the CPU.  The card is
    synchronised before the trace stops, and the chrome trace is read once.
    Yields a dict that holds, after the block, ``events`` (``parse_trace``'s
    ms per name: the device's events on the card, the CPU ops by their own
    time on the CPU), ``trace`` (those events themselves, chrome-trace
    dicts) and ``profile`` (the ``torch.profiler.profile``).  The
    trace is kept as ``<log_dir>/trace.json`` only when ``log_dir`` is
    given; otherwise it is written to a temporary directory that is
    removed."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    holder = {}
    with profile(activities=activities) as prof:
        yield holder
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    cats = DEVICE_CATEGORIES if dev.type == "cuda" else ("cpu_op",)
    with tempfile.TemporaryDirectory(prefix="vargp_torch_trace_") as tmp:
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir or tmp, TRACE_NAME)
        prof.export_chrome_trace(path)
        holder["trace"] = _select(_load(path), cats)
    holder["events"] = _ms(holder["trace"], own_time=dev.type != "cuda")
    holder["profile"] = prof


def _trace_file(path: str) -> str | None:
    """``path`` itself, or the newest chrome trace under the directory."""
    if os.path.isfile(path):
        return path
    files = [f for pat in ("*.json", "*.json.gz")
             for f in glob.glob(os.path.join(path, "**", pat), recursive=True)]
    return max(files, key=os.path.getmtime) if files else None


def _load(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    return trace.get("traceEvents", []) if isinstance(trace, dict) else trace


def _own_times(events: list) -> collections.Counter:
    """Each event's duration less the durations of the events nested in it
    on its thread (one op calling another is counted once)."""
    own = collections.Counter()
    by_thread = collections.defaultdict(list)
    for e in events:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []  # (end, name)
        for e in evs:
            while stack and e["ts"] >= stack[-1][0]:
                stack.pop()
            own[e["name"]] += e["dur"]
            if stack:
                own[stack[-1][1]] -= e["dur"]
            stack.append((e["ts"] + e["dur"], e["name"]))
    return own


def _select(events: list, categories) -> list:
    """The complete events ("X") whose category is in ``categories``."""
    return [e for e in events
            if e.get("ph") == "X" and "dur" in e and e.get("cat") in categories]


def _ms(events: list, own_time: bool = False) -> dict:
    """ms per event name; with ``own_time`` each less the events nested in
    it."""
    if own_time:
        dur = _own_times(events)
    else:
        dur = collections.Counter()
        for e in events:
            dur[e["name"]] += e["dur"]
    return {k: v / 1000.0 for k, v in dur.items()}


def parse_trace(path: str, categories=DEVICE_CATEGORIES, own_time: bool = False,
                counts: bool = False):
    """Device ms per op name in a ``torch.profiler`` chrome trace: ``path``
    is the file or a directory (its newest ``*.json`` / ``*.json.gz``); an
    empty directory gives {}.  Only complete events ("X") whose category is
    in ``categories`` count: by default the device's kernels, copies and
    fills, each under its own name.  ``own_time`` subtracts nested events'
    durations (for host ops, which nest).  With ``counts`` returns
    (ms per name, events per name)."""
    f = _trace_file(path)
    if f is None:
        return ({}, {}) if counts else {}
    events = _select(_load(f), categories)
    ms = _ms(events, own_time)
    if counts:
        return ms, dict(collections.Counter(e["name"] for e in events))
    return ms


def profile_fn(fn, *args, iters: int = 10, top: int = 15, device=None) -> dict:
    """Call ``fn(*args)`` once to warm up, then ``iters`` times under
    ``device_trace``.  Returns a dict: ``top``, the ``top`` ops by ms per
    call (device kernels, copies and fills on the card; CPU ops by their
    own time on the CPU); ``events_per_call``, the kernel events traced per
    call on the card (the CPU ops' events on the CPU), and
    ``launches_per_call`` the events per call of each op name;
    ``busy_ms``, the summed ms per call."""
    dev = resolve_device(device)
    fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    with device_trace(device=dev) as tr:
        for _ in range(iters):
            fn(*args)
    ms = tr["events"]
    n = collections.Counter(e["name"] for e in tr["trace"])
    kernels = sum(e["cat"] == "kernel" for e in tr["trace"]) if dev.type == "cuda" else n.total()
    ranked = sorted(ms.items(), key=lambda kv: -kv[1])[:top]
    return {
        "top": {k: v / iters for k, v in ranked},
        "events_per_call": kernels / iters,
        "launches_per_call": {k: v / iters for k, v in n.items()},
        "busy_ms": sum(ms.values()) / iters,
    }
