"""The traced slice: ``torch.profiler``'s events read into plain records.

The slice is a short steady run at the end of a ``--trace 1`` run's
window, under ``torch.profiler`` with CPU and CUDA activities and the ops'
input shapes.  ``read_slice`` takes the profiler's events in memory
(nothing is written to disk) and keeps, as the port's
``utils/profiling.py::parse_trace`` counts them, the device's kernels,
copies and fills (``Memcpy ...``, ``Memset ...``) and none of the host's
rows; besides, the host's ops with their input shapes and the runtime
calls, and the profiler's link from each device event to the op that
launched it (a device event's linked correlation id is the op's id).
"""

import bisect
import heapq
import re
from dataclasses import dataclass, field

OPERATOR_PREFIX = "vargp_torch::"
# the library's products and triangular solves (cuBLAS and CUTLASS), by
# kernel name
LIBRARY_PRODUCTS = re.compile(r"gemm|gemv|trsm|trsv|xmma|cutlass", re.IGNORECASE)


@dataclass
class DeviceEvent:
    name: str
    start: int  # ns, on the host's clock
    end: int
    op: int  # the id of the host op that launched it, 0 when none


@dataclass
class HostEvent:
    name: str
    start: int
    end: int
    id: int
    shapes: list


@dataclass
class Slice:
    """One traced slice: [t0, t1] on the host's clock (ns), the work done
    in it (``units``: steps or calls), its device events, the host's ops
    and runtime calls."""

    t0: int
    t1: int
    units: int
    device: list = field(default_factory=list)
    ops: dict = field(default_factory=dict)  # id -> HostEvent
    host: list = field(default_factory=list)  # ops and runtime calls, HostEvent

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9


def read_slice(prof, t0: int, t1: int, units: int) -> Slice:
    """The slice [t0, t1] of a stopped ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    out = Slice(t0=t0, t1=t1, units=units)
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CUDA:
            out.device.append(DeviceEvent(e.name(), start, end, e.linked_correlation_id()))
        elif e.device_type() == DeviceType.CPU and end > start:
            h = HostEvent(e.name(), start, end, e.correlation_id(), e.shapes())
            out.host.append(h)
            if e.linked_correlation_id() == 0 and h.id:
                out.ops[h.id] = h
    out.device.sort(key=lambda d: d.start)
    return out


def busy_intervals(s: Slice) -> list:
    """The union of the device events' intervals inside the slice, merged
    and sorted: [(start, end), ...]."""
    spans = sorted((max(d.start, s.t0), min(d.end, s.t1)) for d in s.device)
    merged = []
    for a, b in spans:
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [tuple(m) for m in merged]


def busy_s(s: Slice) -> float:
    return sum(b - a for a, b in busy_intervals(s)) / 1e9


def device_ops(s: Slice, top: int = 10) -> list:
    """The device's operations that took most time: [[name, seconds], ...]."""
    total = {}
    for d in s.device:
        total[d.name] = total.get(d.name, 0) + (d.end - d.start)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[name, ns / 1e9] for name, ns in ranked]


def idle_gaps(s: Slice, top: int = 10) -> list:
    """The device's idle time inside the slice, by what the host was doing
    when each gap began (the innermost host op or runtime call running
    then): [[name, seconds], ...], the largest sums first."""
    busy = busy_intervals(s)
    edges = [s.t0] + [x for a, b in busy for x in (a, b)] + [s.t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    host = sorted(s.host, key=lambda h: h.start)
    starts = [h.start for h in host]
    active, i, total = [], 0, {}
    for a, b in gaps:
        j = bisect.bisect_right(starts, a)
        while i < j:
            heapq.heappush(active, (-host[i].start, host[i].end, host[i].name))
            i += 1
        while active and active[0][1] <= a:
            heapq.heappop(active)
        name = active[0][2] if active else "host, outside any op"
        total[name] = total.get(name, 0) + (b - a)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[name, ns / 1e9] for name, ns in ranked]


def operator_calls(s: Slice) -> list:
    """Each call of a ``vargp_torch::`` operator in the slice with the
    device time of the events it launched: [(name, shapes, device ns)]."""
    launched = {}
    for d in s.device:
        if d.op in s.ops:
            launched[d.op] = launched.get(d.op, 0) + (d.end - d.start)
    return [(op.name, op.shapes, launched.get(op.id, 0)) for op in s.ops.values()
            if op.name.startswith(OPERATOR_PREFIX) and s.t0 <= op.start <= s.t1]


def library_products_ns(s: Slice) -> int:
    """Device ns of the library's products and triangular solves."""
    return sum(d.end - d.start for d in s.device if LIBRARY_PRODUCTS.search(d.name))
