"""The port's spans and launch counters (``utils/tracing.py``) on the CPU:
recorded only inside a ``torch.profiler`` session, nested with their
parents and call ids, on the profiler's clock; the span tree of
``predict`` and of every model's train block and ``elbo_step``; none in
an exported predictor; the operator's per-span summary
(``utils/profiling.py``)."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vargp_tpu_torch import data as tdata
from vargp_tpu_torch.experiments import retrain_run as TRR
from vargp_tpu_torch.models import global_svgp as TG
from vargp_tpu_torch.models import vargp as V
from vargp_tpu_torch.models import vargp_retrain as TR
from vargp_tpu_torch.train import loop as TL
from vargp_tpu_torch.train import loop_global as TLG
from vargp_tpu_torch.utils import profiling, tracing

O, M, D, B, H, N_F = 2, 8, 4, 16, 2, 3


@pytest.fixture(autouse=True)
def _empty():
    tracing.clear()
    yield
    tracing.clear()


def _case(seed: int = 0):
    """A 2-class task after one earlier task, at a size the CPU runs at
    once: (params, prev, prior, cfg, x, y, w, generator)."""
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen)

    cfg = V.VARGPConfig(M=M, out_size=O, in_size=D, n_f=N_F, n_var_samples=H)
    P = V._theta_size(cfg)
    first, _ = V.init_params(normal(P + 1), normal(O, M, 1), normal(O, M, D, scale=0.3), cfg)
    params, prior = V.init_params(normal(P + 1), normal(O, M, 1), normal(O, M, D, scale=0.3),
                                  cfg, kernel_prior_from=first.kernel)
    x = normal(B, D, scale=0.3)
    y = torch.randint(0, O, (B,), generator=gen)
    return params, (V.freeze_task(first),), prior, cfg, x, y, torch.ones(B), gen


def _predict(case):
    params, prev, _, cfg, x, _, _, gen = case
    noise = TL.draw_noise(gen, cfg, 0, B)
    return V.predict(params, prev, x, {"hyper_eps": noise["hyper_eps"],
                                       "lik_eps": noise["lik_eps"]}, cfg, device="cpu")


def _tree(spans) -> list:
    """(name, parent's name) of each span, by start."""
    by_id = {s.id: s.name for s in spans}
    return [(s.name, by_id.get(s.parent)) for s in sorted(spans, key=lambda s: s.start)]


def test_spans_are_recorded_only_inside_a_profiler_session():
    case = _case()
    assert tracing.span("predict") is tracing.span("posterior")  # the shared no-op
    _predict(case)
    assert tracing.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        _predict(case)
    assert [s.name for s in tracing.spans()].count("predict") == 1
    _predict(case)
    assert [s.name for s in tracing.spans()].count("predict") == 1
    tracing.clear()
    assert tracing.spans() == []


def test_parents_and_call_ids():
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("predict"):
            with tracing.span("posterior"):
                pass
            with tracing.span("likelihood"):
                pass
        with tracing.span("train_block"):
            for _ in range(2):
                with tracing.span("elbo_step"):
                    with tracing.span("backward"):
                        pass
    got = {s.id: s for s in tracing.spans()}
    by_name = {}
    for s in got.values():
        by_name.setdefault(s.name, []).append(s)
    (predict,), (block,) = by_name["predict"], by_name["train_block"]
    assert predict.parent == 0 and block.parent == 0
    assert {s.parent for s in by_name["posterior"] + by_name["likelihood"]} == {predict.id}
    assert {s.call for s in by_name["posterior"] + by_name["likelihood"]} == {predict.call}
    steps = sorted(by_name["elbo_step"], key=lambda s: s.start)
    assert [s.parent for s in steps] == [block.id, block.id]
    # each step opens a call id of its own, shared by what nests in it
    assert len({predict.call, block.call, steps[0].call, steps[1].call}) == 4
    assert sorted((got[s.parent].call, s.call) for s in by_name["backward"]) == sorted(
        (s.call, s.call) for s in steps)


def test_a_span_contains_the_ops_the_profiler_recorded_in_it():
    """The spans' clock is the profiler's: every ``aten::`` op recorded
    inside a span lies within its [start, end]."""
    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("predict"):
            (a @ a).relu().sum()
    (s,) = tracing.spans()
    ops = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("aten::")]
    assert {e.name() for e in ops} >= {"aten::mm", "aten::relu", "aten::sum"}
    for e in ops:
        assert s.start <= e.start_ns() <= e.end_ns() <= s.end, e.name()
    # the span's own row in the profiler's trace lies inside it too
    (row,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "predict"]
    assert s.start <= row.start_ns() <= row.end_ns() <= s.end


def test_predict_emits_its_span_tree():
    case = _case()
    with profile(activities=[ProfilerActivity.CPU]):
        _predict(case)
    spans = tracing.spans()
    assert _tree(spans) == [("predict", None), ("posterior", "predict"),
                            ("marginal", "predict"), ("likelihood", "predict")]
    assert len({s.call for s in spans}) == 1


def _train_two_steps(model: str):
    """One train block of two steps of ``model``: VAR-GP's ``train_block``;
    for the global model and Retrain a one-epoch ``train_task`` on a
    2-class toy task of 100 rows in batches of 50."""
    if model == "vargp":
        params, prev, prior, cfg, _, _, _, gen = _case()
        n = 2 * B
        data_x = torch.randn(n, D, generator=gen) * 0.3
        data_y = torch.randint(0, O, (n,), generator=gen)
        hp = TL.TrainHyperparams(lr=1e-2, batch_size=B)
        opt = TL.make_optimizer(hp)
        TL.train_block(params, opt.init(params), prev, prior, None, n, data_x, data_y,
                       torch.ones(n), gen, cfg=cfg, opt=opt, beta=1.0, batch_size=B,
                       n_epochs=1, device="cpu")
        return
    toy = tdata.filter_by_class(tdata.make_toy_dataset(seed=0), [0, 1])
    dims = dict(M=4, out_size=4, in_size=2, n_f=2, n_var_samples=2)
    hp = TL.TrainHyperparams(epochs=1, batch_size=50, eval_interval=1)
    if model == "global":
        TLG.train_task(0, 0, toy, toy, toy, TG.GlobalSVGPConfig(**dims), hp, device="cpu")
    else:
        TRR.train_task(TRR.RetrainDraws(torch.Generator().manual_seed(0)), 0, toy, toy,
                       TR.RetrainConfig(**dims), hp, device="cpu")


@pytest.mark.parametrize("model", ["vargp", "global", "retrain"])
def test_a_train_block_emits_a_step_tree_per_step(model):
    """Every model's step is ``train.loop.gradient_step``: a train block
    holds one ``elbo_step`` a step, with its ``backward`` and ``update``
    (and VAR-GP's model spans) nested in it under its call id."""
    with profile(activities=[ProfilerActivity.CPU]):
        _train_two_steps(model)
    spans = tracing.spans()
    inner = [("posterior", "elbo_step"), ("marginal", "elbo_step"),
             ("likelihood", "elbo_step")] if model == "vargp" else []
    step = [("elbo_step", "train_block"), *inner, ("backward", "elbo_step"),
            ("update", "elbo_step")]
    assert _tree(spans) == [("train_block", None)] + step + step
    steps = [s for s in spans if s.name == "elbo_step"]
    for st in steps:
        assert {s.call for s in spans if s.parent == st.id} == {st.call}


def test_the_exported_predictor_holds_no_span(tmp_path):
    """``torch.export`` traces ``predict`` with its spans off, even inside
    a profiler session: the graph has no profiler node and the loaded
    program records no span."""
    from vargp_tpu_torch.utils import export as E

    params, prev, _, cfg, x, _, _, gen = _case(1)
    with profile(activities=[ProfilerActivity.CPU]):
        path = E.export_predictor(params, prev, cfg, B, str(tmp_path / "p.pt2"), n_f=N_F,
                                  n_var_samples=H, device="cpu")
    assert tracing.spans() == []
    program = torch.export.load(path)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]


def test_span_summary_splits_host_self_and_device_time():
    S = tracing.Span
    spans = [S("predict", 0, 100, 1, 0, 1), S("posterior", 10, 40, 2, 1, 1),
             S("marginal", 50, 70, 3, 1, 1)]
    # (launch ns, device ns): two in the posterior, one in predict's own
    # time, one outside any span
    launches = [(12, 1_000_000), (39, 3_000_000), (45, 2_000_000), (150, 5_000_000)]
    out = profiling.span_summary(spans, launches, calls=2)
    assert out["predict"]["host_ms"] == pytest.approx(100 / 1e6 / 2)
    assert out["predict"]["self_ms"] == pytest.approx(50 / 1e6 / 2)
    assert out["posterior"]["self_ms"] == out["posterior"]["host_ms"]
    assert out["posterior"]["device_ms"] == pytest.approx(2.0)
    assert out["posterior"]["events"] == 1.0
    assert out["predict"]["device_ms"] == pytest.approx(1.0)
    assert out["marginal"]["events"] == 0.0


class _Event:
    """A stand-in for a profiler event: the accessors ``launch_times`` reads."""

    def __init__(self, name, device, corr, start, end):
        self._v = (name, device, corr, start, end)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def correlation_id(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def end_ns(self):
        return self._v[4]


def test_launch_times_join_each_device_event_to_its_runtime_call():
    """A kernel and a copy at the start of the runtime call sharing their
    correlation id; an op and a device row that no runtime call launched
    (a user annotation's, sharing an op's id) are left out."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    CPU, CUDA = DeviceType.CPU, DeviceType.CUDA
    events = [_Event("aten::mm", CPU, 7, 100, 400), _Event("cudaLaunchKernel", CPU, 120, 150, 160),
              _Event("sgemm", CUDA, 120, 300, 340), _Event("cudaMemcpyAsync", CPU, 121, 200, 210),
              _Event("Memcpy HtoD", CUDA, 121, 350, 355), _Event("predict", CUDA, 7, 300, 355)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    assert profiling.launch_times(prof) == [(150, 40), (200, 5)]


def test_profile_fn_sums_the_spans_per_call():
    case = _case()
    out = profiling.profile_fn(_predict, case, iters=3, device="cpu")
    spans = out["spans"]
    assert set(spans) == {"predict", "posterior", "marginal", "likelihood"}
    p = spans["predict"]
    assert 0 < p["self_ms"] < p["host_ms"]
    assert sum(s["self_ms"] for s in spans.values()) == pytest.approx(p["host_ms"])
    assert all(s["events"] == 0 for s in spans.values())  # no device on the CPU


def test_no_launch_is_counted_on_the_cpu():
    with profile(activities=[ProfilerActivity.CPU]):
        _predict(_case())
    assert sum(tracing.LAUNCHES.values()) == 0
