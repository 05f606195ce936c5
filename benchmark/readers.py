"""The quantities the per-layer metrics read, one function each.

Each ``metrics/<name>.py`` binds one of these as its ``read``: a metric of
another cell is a new one-line file.  Each takes a ``cell.Context`` and
returns a number, or None when its slice holds nothing to read.  A unit
is one training step or one ``predict`` call, as the cell's kind counts
them.
"""

from benchmark import costs, trace


def launches_per_unit(ctx):
    """Host dispatch: the card's events (kernels, copies, fills) per unit
    in the card-only slice, every launch the host's Python and dispatcher
    make, library and elementwise ones included."""
    s = ctx.slice
    return len(s.device) / s.units if s.device and s.units else None


def products_ms_per_unit(ctx):
    """GP math: device ms per unit of the library's matrix products and
    triangular solves (cuBLAS and CUTLASS kernels, by name)."""
    ns = trace.library_products_ns(ctx.slice)
    return ns / 1e6 / ctx.slice.units if ns and ctx.slice.units else None


def kernels_roofline(ctx):
    """Kernels: the hand-written kernels' share of their roofline, in %:
    the sum over every ``vargp_torch::`` operator call of the slice that
    traces the host's ops of its bound (its operations at the peak or its
    bytes at the memory rate, whichever takes longer, from the frozen
    counts at the call's shapes) over the sum of the device time of the
    events the call launched (the profiler's link from each event to its
    op)."""
    bound = took = 0.0
    for name, shapes, ns in trace.operator_calls(ctx.ops_slice):
        cost = costs.operator_cost(name, shapes)
        if cost is None or not ns:
            continue
        bound += costs.bound_s(*cost)
        took += ns / 1e9
    return 100.0 * bound / took if took else None


def idle_share(ctx):
    """Device: the share of the card-only slice's wall time, in %, in which
    no kernel, copy or fill ran: 1 - the union of the device events'
    intervals over the slice's length, the same clock on both sides."""
    s = ctx.slice
    if not s.device or s.t1 <= s.t0:
        return None
    return 100.0 * (1.0 - trace.busy_s(s) / s.seconds)


def mfu(ctx):
    """The whole step or call: its model FLOPs from the shapes
    (``costs.py``) times the unprofiled window's units per second, over
    the peak of f32-accurate arithmetic, in %."""
    if not ctx.rate or not ctx.unit_flops:
        return None
    return 100.0 * ctx.unit_flops * ctx.rate / costs.PEAK_FLOPS
