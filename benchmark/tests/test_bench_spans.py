"""The readers of the program's spans (``spans.py``): on hand-built slices
and spans on the CPU, and, on the card, the clock the spans share with
the traced slice."""

import json
import os
import sys
import time

import pytest
import torch

from benchmark import cell as C
from benchmark import readers, spans, trace
from vargp_tpu_torch.utils import tracing

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
S = tracing.Span


def _context(recorded, monkeypatch):
    """A slice [0, 100] of two calls: the card busy over [10, 40] and
    [60, 70]; the first event launched by op 7 (started at 12), the
    second by op 8 (at 32), the copy by no op.  The same slice stands for
    both of the context's slices."""
    monkeypatch.setattr(tracing, "spans", lambda: list(recorded))
    s = trace.Slice(t0=0, t1=100, units=2)
    s.device = [trace.DeviceEvent("k_gemm", 10, 30, 7), trace.DeviceEvent("k_mine", 20, 40, 8),
                trace.DeviceEvent("Memcpy HtoD", 60, 70, 0)]
    s.host = [trace.HostEvent("aten::mm", 12, 14, 7, []),
              trace.HostEvent("vargp_torch::sym_gram", 32, 34, 8, [])]
    s.ops = {7: s.host[0], 8: s.host[1]}
    return C.Context(slice=s, ops_slice=s, rate=1.0, unit_flops=1.0, config={}, traffic={})


# two predict calls, [5, 50] and [55, 80], the first with its posterior
# [11, 30] and marginal [30, 45]; a span of an earlier slice
CALLS = [S("posterior", 11, 30, 2, 1, 1), S("marginal", 30, 45, 3, 1, 1),
         S("predict", 5, 50, 1, 0, 1), S("predict", 55, 80, 4, 0, 2),
         S("predict", -200, -150, 9, 0, 9)]


def test_host_ms_is_the_mean_predict_span_in_the_slice(monkeypatch):
    ctx = _context(CALLS, monkeypatch)
    assert spans.predict_host_ms(ctx) == pytest.approx((45 + 25) / 2 / 1e6)


def test_idle_share_counts_the_idle_time_inside_predict_alone(monkeypatch):
    ctx = _context(CALLS, monkeypatch)
    # idle inside the calls: [5, 10), [40, 50), [55, 60), [70, 80)
    assert spans.predict_idle_share(ctx) == pytest.approx(30.0)
    # the slice's idle share adds the idle time between calls
    assert readers.idle_share(ctx) == pytest.approx(60.0)


def test_posterior_device_time_follows_the_launching_op(monkeypatch):
    # op 7 began at 12, inside the posterior; op 8 at 32, in the marginal
    ctx = _context(CALLS, monkeypatch)
    assert spans.posterior_device_ms(ctx) == pytest.approx(20 / 2 / 1e6)
    # without the posterior span the same event belongs to predict
    ctx = _context([c for c in CALLS if c.name != "posterior"], monkeypatch)
    assert spans.posterior_device_ms(ctx) == 0.0


@pytest.mark.parametrize("read", [spans.predict_host_ms, spans.predict_idle_share,
                                  spans.posterior_device_ms])
def test_no_spans_read_nothing(read, monkeypatch):
    """No span in the slice, or a program with no tracing module (the
    parent of the spans' change): None, and no error."""
    assert read(_context([CALLS[-1]], monkeypatch)) is None
    ctx = _context(CALLS, monkeypatch)
    import vargp_tpu_torch.utils

    monkeypatch.delattr(vargp_tpu_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "vargp_tpu_torch.utils.tracing", None)
    assert read(ctx) is None


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", [m["name"] for m in _bench()["per_layer"]
                                  if m["name"].split(".", 1)[0] in
                                  ("predict_host_ms", "predict_idle_share",
                                   "posterior_device_ms")])
def test_each_span_metric_binds_its_reader(name):
    assert C.reader(ROOT, name) is getattr(spans, name.split(".", 1)[0])


@pytest.mark.card
@pytest.mark.parametrize("name", ["smnist_final.predict", "pmnist_final.predict"])
def test_every_launch_of_predict_lies_inside_its_span(name):
    """A cell's calls traced on the card alone: every kernel launch that the
    runtime recorded lies inside a ``predict`` span (the batch's copy and
    the read-back launch no kernel).  The nearest launch to a span's edge
    is printed: the clocks of the spans and of the runtime calls differ by
    less than that."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    mix = C.make_mix(C.load(ROOT, name), 2**31 + 23, dev)
    mix.setup()
    noise = mix._noise(0)
    batches = mix.splits[0][0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        for xb in batches:
            mix._call(noise, xb)
        t1 = time.time_ns()
    s = trace.read_slice(prof, t0, t1, len(batches))
    calls = spans._spans(s, "predict")
    assert len(calls) == s.units
    launches = [h for h in s.host if "LaunchKernel" in h.name]
    assert len(launches) >= s.units
    before, after = [], []
    for h in launches:
        inside = [c for c in calls if c.start <= h.start and h.end <= c.end]
        assert inside, (h.name, h.start)
        before.append(h.start - inside[0].start)
        after.append(inside[0].end - h.end)
    print(f"{name}: {len(launches)} launches in {len(calls)} predict spans; the nearest "
          f"launch {min(before)} ns after a span's start, {min(after)} ns before its end")
    mix.release()
