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
It also sums the port's spans (``utils.tracing``) recorded in the trace,
with the device's events each launched (:func:`span_summary`).
"""

import bisect
import collections
import glob
import gzip
import json
import os
import tempfile
import time
from contextlib import contextmanager

import torch

from vargp_tpu_torch.ops.device import resolve_device
from vargp_tpu_torch.utils import tracing

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


def launch_times(prof) -> list:
    """(launch ns, device ns) of each kernel, copy and fill in a stopped
    ``torch.profiler.profile``: each device event at the start of the
    CUDA runtime or driver call (a host event named ``cu...``) that
    launched it, the two sharing a correlation id, on the clock of
    ``time.time_ns``."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    calls = {e.correlation_id(): e.start_ns() for e in events
             if e.device_type() == DeviceType.CPU and e.name().startswith("cu")}
    return [(calls[e.correlation_id()], e.end_ns() - e.start_ns()) for e in events
            if e.device_type() == DeviceType.CUDA and e.correlation_id() in calls]


def span_summary(spans: list, launches: list, calls: int) -> dict:
    """Per span name, per call of ``calls``: ``host_ms``, the spans'
    duration; ``self_ms``, that less the time of the spans nested in them;
    ``device_ms`` and ``events``, the device's events launched while the
    span was the innermost open one (``launches``: (launch ns, device ns)
    each)."""
    ordered = sorted(spans, key=lambda s: s.start)
    starts = [s.start for s in ordered]
    by_id = {s.id: s for s in spans}
    out = {s.name: dict(host_ms=0.0, self_ms=0.0, device_ms=0.0, events=0.0) for s in spans}
    for s in spans:
        ms = (s.end - s.start) / 1e6 / calls
        out[s.name]["host_ms"] += ms
        out[s.name]["self_ms"] += ms
        if s.parent in by_id:
            out[by_id[s.parent].name]["self_ms"] -= ms
    for t, ns in launches:
        # spans nest: the latest-starting one still open at t is innermost
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and ordered[i].end < t:
            i -= 1
        if i >= 0:
            out[ordered[i].name]["device_ms"] += ns / 1e6 / calls
            out[ordered[i].name]["events"] += 1 / calls
    return out


def profile_fn(fn, *args, iters: int = 10, top: int = 15, device=None) -> dict:
    """Call ``fn(*args)`` once to warm up, then ``iters`` times under
    ``device_trace``.  Returns a dict: ``top``, the ``top`` ops by ms per
    call (device kernels, copies and fills on the card; CPU ops by their
    own time on the CPU); ``events_per_call``, the kernel events traced per
    call on the card (the CPU ops' events on the CPU), and
    ``launches_per_call`` the events per call of each op name;
    ``busy_ms``, the summed ms per call; ``spans``, :func:`span_summary`
    of the port's spans in the trace (no device events on the CPU)."""
    dev = resolve_device(device)
    fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time_ns()
    with device_trace(device=dev) as tr:
        for _ in range(iters):
            fn(*args)
    spans = [s for s in tracing.spans() if s.start >= t0]
    ms = tr["events"]
    n = collections.Counter(e["name"] for e in tr["trace"])
    kernels = sum(e["cat"] == "kernel" for e in tr["trace"]) if dev.type == "cuda" else n.total()
    ranked = sorted(ms.items(), key=lambda kv: -kv[1])[:top]
    return {
        "top": {k: v / iters for k, v in ranked},
        "events_per_call": kernels / iters,
        "launches_per_call": {k: v / iters for k, v in n.items()},
        "busy_ms": sum(ms.values()) / iters,
        "spans": span_summary(spans, launch_times(tr["profile"]) if dev.type == "cuda" else [],
                              iters),
    }
