"""The deep-kernel cell ``smnist_dkl.predict`` on the CPU: found by name
through new files alone, its frozen model FLOPs by hand, ``correct`` at a
tiny size (the port agrees with the float64 reference, the TF32 control
and the planted fault do not), the readers of the ``features`` spans, and
no ``jax`` or JAX package in what it imports."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import cell as C
from benchmark import costs_dkl, readings, run, spans_dkl, trace
from benchmark.tests.conftest import TINY, TINY_PREDICT
from vargp_tpu_torch.utils import tracing

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CPU = torch.device("cpu")
NAME = "smnist_dkl.predict"
# the files the cell brings, relative to benchmark/
NEW_FILES = ["configs/smnist_dkl.json", "traffic/predict_dkl.json", "kinds/predict_dkl.py",
             "limits/smnist_dkl.predict.json", "inputs_dkl.py", "costs_dkl.py", "spans_dkl.py",
             "reference/vargp_dkl.py", "metrics/features_device_ms.smnist_dkl.py",
             "metrics/features_per_call.smnist_dkl.py"]
NEW_METRICS = {"features_device_ms.smnist_dkl": spans_dkl.features_device_ms,
               "features_per_call.smnist_dkl": spans_dkl.features_per_call}
# the tiny cell's limit: its sound runs read 5.7e-6 - 1.8e-5 on the CPU over
# eight seeds (f32 features whose shared offset cancels in the Gram's
# distances), the TF32 control 9.5e-4 - 2.7e-3
TINY_LIMITS = {"probs": 1e-4}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _without_the_cell(bench: dict) -> dict:
    """``bench`` as it was before the cell: no configuration, cell or
    metric of it, and the cell in no metric's list."""
    bench = json.loads(json.dumps(bench))
    bench["configs"] = [c for c in bench["configs"] if c["name"] != "smnist_dkl"]
    bench["workloads"] = [w for w in bench["workloads"] if w["name"] != NAME]
    bench["per_layer"] = [m for m in bench["per_layer"] if m["name"] not in NEW_METRICS]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if NAME in m.get("workloads", []):
            m["workloads"].remove(NAME)
    return bench


def test_the_cell_is_found_by_name_through_new_files_alone(tmp_path):
    """The benchmark without the cell's files and entries, then with them
    added: the cell loads, reports the S-MNIST metrics and its own two, and
    no file that was there changes."""
    here = tmp_path / "benchmark"
    shutil.copytree(os.path.join(ROOT, "benchmark"), here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for f in NEW_FILES:
        (here / f).unlink()
    bench = _bench()
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(_without_the_cell(bench), f)
    with pytest.raises(KeyError):
        C.load(str(tmp_path), NAME)
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    for f in NEW_FILES:
        shutil.copy(os.path.join(ROOT, "benchmark", f), here / f)
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    cell = C.load(str(tmp_path), NAME)
    assert all(p.read_bytes() == b for p, b in before.items())
    assert cell.config["model"]["dkl"] and cell.config["reduced"] == []
    assert cell.config["phi_widths"] == [784, 256, 256, 64]
    assert {m["name"] for m in cell.end_to_end} == {"predict_rows_per_s.smnist",
                                                    "predict_ms_p95.smnist", "setup_s"}
    smnist = {m["name"] for m in C.load(ROOT, "smnist_final.predict").per_layer}
    assert {m["name"] for m in cell.per_layer} == smnist | set(NEW_METRICS)
    for name, read in NEW_METRICS.items():
        assert C.reader(str(tmp_path), name) is read
    kind = C.kind(str(tmp_path), cell.traffic["kind"])
    assert kind.Mix.__mro__[1].__name__ == "Mix" and "altered_answer" in kind.FAULTS
    assert {k: v for k, v in cell.traffic.items() if k != "kind"} == {
        k: v for k, v in C.load(ROOT, "smnist_final.predict").traffic.items() if k != "kind"}


def test_model_flops_by_hand():
    """H = 20, B = 512, O = 10, S = 300, T = 5, M = 60, phi 784-256-256-64
    (282,624 multiply-adds a row)."""
    cfg = C.load(ROOT, NAME).config
    call = costs_dkl.call_terms(cfg, 20, 512)
    post = costs_dkl.posterior_terms(cfg, 20)
    # K_zx on 64 features 3.932, phi(x) 0.289, L^-1 K_zx 9.216, f_mean
    # 0.061, C_t 3.686
    assert sorted(call.values()) == [61_440_000, 289_406_976, 3_686_400_000, 3_932_160_000,
                                     9_216_000_000]
    assert sum(call.values()) / 1e9 == pytest.approx(17.1854, abs=5e-5)
    # phi over the chain 1.696, K_zz 1.152, the factor 1.800, the whitened
    # terms 0.2196
    assert sorted(post.values()) == [3_600_000, 216_000_000, 1_152_000_000, 1_695_744_000,
                                     1_800_000_000]
    assert sum(post.values()) / 1e9 == pytest.approx(4.8673, abs=5e-5)
    # S-MNIST's splits take 5, 4, 4, 4, 4 calls: 5 builds in 21
    mix = C.make_mix(C.load(ROOT, NAME), 1, CPU)
    assert mix.unit_flops() / 1e9 == pytest.approx(18.344, abs=5e-4)
    assert mix.unit_flops() == pytest.approx(sum(call.values()) + sum(post.values()) * 5 / 21)


@pytest.fixture
def tiny_dkl():
    """The benchmark's tiny cell (``conftest.TINY``) under the deep kernel:
    D = 16, phi 16-256-256-64, a 3-task chain of M = 8, three classes."""
    cfg = dict(TINY, name="tiny_dkl", model=dict(TINY["model"], dkl=True),
               phi_widths=[TINY["model"]["in_size"], 256, 256, 64])
    with open(os.path.join(ROOT, "benchmark", "traffic", "predict_dkl.json")) as f:
        mix = dict(json.load(f), **TINY_PREDICT)
    return C.Cell(name="tiny_dkl.predict", chips=1, config=cfg, traffic=mix,
                  limits=dict(TINY_LIMITS), root=ROOT,
                  end_to_end=[{"name": n, "unit": "u"} for n in
                              ("predict_rows_per_s.tiny", "predict_ms_p95.tiny", "setup_s")])


@pytest.mark.parametrize("what", ["sound", "control", "altered_answer"])
def test_correct_at_a_tiny_size(tiny_dkl, what):
    """The port is correct against the float64 reference; the reference
    computed in TF32 (phi's products included) put in its place is not; nor
    is a run whose ``predict`` returns its first row reversed."""
    if what == "control":
        for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
            r = readings.reading(tiny_dkl, seed, 0.2, CPU, control=True)
            assert not run.check.verdict(r["control"], tiny_dkl.limits), r
            assert run.check.verdict(r["numbers"], tiny_dkl.limits), r
        return
    kind = C.kind(ROOT, "predict_dkl")
    if what == "sound":
        result, _ = run.run_cell(tiny_dkl, 2**31 + 11, 0.3, False, CPU, 0.0)
        assert result["correct"], result["compared"]
        assert result["compared"]["probs"]["value"] < TINY_LIMITS["probs"] / 4
    else:
        with kind.FAULTS[what]():
            result, _ = run.run_cell(tiny_dkl, 2**31 + 5, 0.3, False, CPU, 0.0)
        assert not result["correct"], result["compared"]


def _context(recorded, monkeypatch):
    """A slice [0, 100] of two calls: op 7 (at 12) launched [10, 30], op 8
    (at 32) launched [20, 40], the copy no op."""
    monkeypatch.setattr(tracing, "spans", lambda: list(recorded))
    s = trace.Slice(t0=0, t1=100, units=2)
    s.device = [trace.DeviceEvent("k_gemm", 10, 30, 7), trace.DeviceEvent("k_relu", 20, 40, 8),
                trace.DeviceEvent("Memcpy HtoD", 60, 70, 0)]
    s.host = [trace.HostEvent("aten::mm", 12, 14, 7, []),
              trace.HostEvent("aten::relu", 32, 34, 8, [])]
    s.ops = {7: s.host[0], 8: s.host[1]}
    return C.Context(slice=s, ops_slice=s, rate=1.0, unit_flops=1.0, config={}, traffic={})


S = tracing.Span
# two calls: the first builds (posterior [10, 30] with phi over the chain
# [11, 20]) and its marginal [30, 45] applies phi twice ([31, 33], [33,
# 36]); the second's marginal [56, 70] applies it twice; a span before the
# slice
CALLS = [S("features", 11, 20, 3, 2, 1), S("posterior", 10, 30, 2, 1, 1),
         S("features", 31, 33, 5, 4, 1), S("features", 33, 36, 6, 4, 1),
         S("marginal", 30, 45, 4, 1, 1), S("predict", 5, 50, 1, 0, 1),
         S("features", 57, 60, 9, 8, 2), S("features", 60, 62, 10, 8, 2),
         S("marginal", 56, 70, 8, 7, 2), S("predict", 55, 80, 7, 0, 2),
         S("features", -90, -80, 12, 0, 9)]


def test_features_readers(monkeypatch):
    ctx = _context(CALLS, monkeypatch)
    # op 7 began at 12, inside phi over the chain; op 8 at 32, inside phi
    # over the batch: 20 + 20 ns over two calls
    assert spans_dkl.features_device_ms(ctx) == pytest.approx(40 / 2 / 1e6)
    assert spans_dkl.features_per_call(ctx) == pytest.approx(5 / 2)
    # outside every features span the same events count nothing
    ctx = _context([c for c in CALLS if c.name != "features" or c.start > 40], monkeypatch)
    assert spans_dkl.features_device_ms(ctx) == 0.0
    assert spans_dkl.features_per_call(ctx) == pytest.approx(2 / 2)


@pytest.mark.parametrize("read", list(NEW_METRICS.values()))
def test_no_features_span_reads_nothing(read, monkeypatch):
    """No ``features`` span in the slice (the RBF cells, or a program that
    records none), or a program with no tracing module: None, no error."""
    assert read(_context([c for c in CALLS if c.name != "features"], monkeypatch)) is None
    assert read(_context([CALLS[-1]], monkeypatch)) is None
    ctx = _context(CALLS, monkeypatch)
    import vargp_tpu_torch.utils

    monkeypatch.delattr(vargp_tpu_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "vargp_tpu_torch.utils.tracing", None)
    assert read(ctx) is None


def test_no_jax_or_jax_package_in_the_cell_or_its_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys, json; sys.path.insert(0, '.');"
            "from benchmark import cell as C;"
            f"[C.reader('.', m) for m in {sorted(NEW_METRICS)!r}];"
            "C.kind('.', 'predict_dkl'); import benchmark.port;"
            "benchmark.port.port_modules();"
            "print(sorted({m.split('.', 1)[0] for m in sys.modules}"
            " & {'jax', 'jaxlib', 'flax', 'vargp_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    ref = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.');"
         "import benchmark.reference.vargp_dkl;"
         "print(sorted(m for m in sys.modules if m.split('.', 1)[0].startswith('vargp')"
         " or m.split('.', 1)[0] in ('jax', 'jaxlib', 'flax')))"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr
    assert ref.stdout.strip() == "[]"
