"""The per-layer metrics read from the deep kernel's ``features`` spans.

Under the deep kernel the port opens a ``features`` span around each
application of its feature map phi, nested in ``posterior`` or
``marginal`` (``vargp_tpu_torch/utils/tracing.py``).  The readers join
those spans with the traced slices' events as ``spans.py``'s readers join
theirs, and return None when the program records no ``features`` span (a
program without them, or a cell without the deep kernel).
"""

import bisect

from benchmark import spans


def features_device_ms(ctx):
    """Deep kernel feature map: the device ms per call of the events
    launched inside a ``features`` span (phi's products, biases and
    ReLUs).  A device event belongs to the innermost span open when the
    host op that launched it began, through the ops slice's link from the
    event to that op, as ``spans.posterior_device_ms`` reads it."""
    s = ctx.ops_slice
    recorded = spans._spans(s)
    if not any(x.name == "features" for x in recorded) or not s.device or not s.units:
        return None
    starts = [x.start for x in recorded]
    ns = 0
    for d in s.device:
        op = s.ops.get(d.op)
        if op is None:
            continue
        # spans nest: the latest-starting one still open is the innermost
        k = next((k for k in range(bisect.bisect_right(starts, op.start) - 1, -1, -1)
                  if recorded[k].end >= op.start), None)
        if k is not None and recorded[k].name == "features":
            ns += d.end - d.start
    return ns / 1e6 / s.units


def features_per_call(ctx):
    """Deep kernel feature map: ``features`` spans per call in the
    card-only slice, one for each application of phi: to the batch and to
    the chain in every call's marginal, to the chain again in each call
    that builds the posterior."""
    s = ctx.slice
    n = len(spans._spans(s, "features"))
    return n / s.units if n and s.units else None
