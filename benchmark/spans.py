"""The per-layer metrics read from the program's own spans.

The port records a span at each layer boundary of a ``predict`` call
(``predict``, ``posterior``, ``marginal``, ``likelihood``) while a
``torch.profiler`` session is active, so the traced slices record them
and the unprofiled window does not.  A span's start and end are on
``time.time_ns()``, the clock of the slices' bounds and events.  Each
reader takes the spans that start inside its slice and joins them with
that slice's events; it returns None when the program records no span
(a program without ``vargp_tpu_torch.utils.tracing``) or the slice holds
nothing to read.
"""

import bisect

from benchmark import trace


def _spans(s, name: str | None = None) -> list:
    """The program's spans, sorted by start, that start inside slice ``s``
    (all names, or ``name``'s)."""
    try:
        from vargp_tpu_torch.utils import tracing
    except ImportError:
        return []
    return sorted((x for x in tracing.spans()
                   if s.t0 <= x.start <= s.t1 and name in (None, x.name)),
                  key=lambda x: x.start)


def predict_host_ms(ctx):
    """Host dispatch: the host's ms per call inside ``predict`` in the
    card-only slice, from its entry to its return: its checks and the
    enqueue of its launches.  The caller's copy of the batch and the
    read-back of the probabilities lie outside."""
    calls = _spans(ctx.slice, "predict")
    if not calls or not ctx.slice.units:
        return None
    return sum(x.end - x.start for x in calls) / 1e6 / ctx.slice.units


def predict_idle_share(ctx):
    """Device: the share of the card-only slice's wall time, in %, in which
    the card ran nothing while a ``predict`` span was open.  The rest of
    ``idle_share`` is idle time in the caller, between calls."""
    s = ctx.slice
    calls = _spans(s, "predict")
    if not calls or not s.device or s.t1 <= s.t0:
        return None
    busy = trace.busy_intervals(s)
    idle, i = 0, 0
    for x in calls:
        a, b = max(x.start, s.t0), min(x.end, s.t1)
        idle += max(b - a, 0)
        while i < len(busy) and busy[i][1] <= a:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < b:
            idle -= min(busy[j][1], b) - max(busy[j][0], a)
            j += 1
    return 100.0 * idle / (s.t1 - s.t0)


def posterior_device_ms(ctx):
    """GP math: the device ms per call of the events launched inside
    ``posterior`` (the Gram K_zz, its factor and inverse, the factored
    posterior).  A device event belongs to the innermost span open when
    the host op that launched it began, through the profiler's link from
    the event to that op.  The slice that traces the host's ops holds the
    link (the card-only one keeps none); its host runs slower, and the
    device time of each event does not depend on the host's pace."""
    s = ctx.ops_slice
    spans = _spans(s)
    if not spans or not s.device or not s.units:
        return None
    starts = [x.start for x in spans]
    ns = 0
    for d in s.device:
        op = s.ops.get(d.op)
        if op is None:
            continue
        # spans nest: the latest-starting one still open is the innermost
        k = next((k for k in range(bisect.bisect_right(starts, op.start) - 1, -1, -1)
                  if spans[k].end >= op.start), None)
        if k is not None and spans[k].name == "posterior":
            ns += d.end - d.start
    return ns / 1e6 / s.units

