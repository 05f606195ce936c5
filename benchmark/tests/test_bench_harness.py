"""The harness on the CPU: cells found by name, the frozen counts, the
result line's keys, the traced slice's arithmetic, and the imports."""

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from benchmark import cell as C
from benchmark import costs, readers, spans, trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_is_found_by_name(name):
    cell = C.load(ROOT, name)
    assert hasattr(C.kind(ROOT, cell.traffic["kind"]), "Mix")
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert C.reader(ROOT, m["name"]) in READERS
    assert cell.config["reduced"] == []


READERS = (readers.launches_per_unit, readers.products_ms_per_unit, readers.kernels_roofline,
           readers.idle_share, readers.mfu, spans.predict_host_ms, spans.predict_idle_share,
           spans.posterior_device_ms)


def test_the_model_and_training_groups_pass_to_the_port_whole():
    from benchmark import port

    cfg = C.load(ROOT, "pmnist_final.predict").config
    assert port.model_config(cfg).M == 100
    hp = port.train_config(dict(cfg, train=dict(cfg["train"], patience=7)))
    assert (hp.lr, hp.beta, hp.patience) == (0.0037, 1.64, 7)


def _write(path, text: str):
    with open(path, "w") as f:
        f.write(text)


@pytest.mark.parametrize("shared", [True, False], ids=["shared_metrics", "new_files"])
def test_a_new_cell_is_picked_up_with_no_file_edited(tmp_path, shared):
    """A configuration, a mix, a kind of work and a metric, each a new file
    with its entry, make a new cell; no file already there changes."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    here = tmp_path / "benchmark"
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    bench = _bench()
    with open(here / "configs" / "pmnist_final.json") as f:
        cfg = dict(json.load(f), name="pmnist_task5", task=5)
    _write(here / "configs" / "pmnist_task5.json", json.dumps(cfg))
    _write(here / "limits" / "pmnist_task5.eval.json", json.dumps({"probs": 1e-4}))
    bench["configs"].append({"name": "pmnist_task5", "source": "https://arxiv.org/abs/2006.05468",
                             "file": "benchmark/configs/pmnist_task5.json", "reduced": [],
                             "why": "a shorter chain"})
    cell_name = "pmnist_task5.eval"
    if shared:  # an existing kind, reported under the S-MNIST cell's metrics
        with open(here / "traffic" / "predict.json") as f:
            _write(here / "traffic" / "eval.json", json.dumps(dict(json.load(f), batch_size=256)))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "smnist_final.predict" in m.get("workloads", []):
                m["workloads"].append(cell_name)
        expect = {m["name"] for m in C.load(ROOT, "smnist_final.predict").per_layer}
    else:  # a kind of work of its own, with a metric and a reader of its own
        _write(here / "kinds" / "evaluate.py",
               "class Mix:\n    def __init__(self, *a):\n        self.args = a\n")
        _write(here / "traffic" / "eval.json", json.dumps(dict(kind="evaluate")))
        _write(here / "metrics" / "launches_per_call.task5.py",
               "from benchmark.readers import launches_per_unit as read  # noqa: F401\n")
        bench["end_to_end"].append({"name": "eval_rows_per_s.task5", "unit": "rows/s",
                                    "better": "higher", "bound": 0.05, "source": "host_clock",
                                    "workloads": [cell_name]})
        bench["per_layer"].append({"name": "launches_per_call.task5", "unit": "events/call",
                                   "better": "lower", "source": "device_trace",
                                   "layer": "host dispatch", "moves": "eval_rows_per_s.task5",
                                   "workloads": [cell_name]})
        expect = {"launches_per_call.task5"}
    bench["workloads"].append({"name": cell_name, "config": "pmnist_task5", "traffic": "eval",
                               "chips": 1, "why": "a shorter chain"})
    _write(tmp_path / "BENCHMARK.json", json.dumps(bench))
    cell = C.load(str(tmp_path), cell_name)
    assert cell.config["task"] == 5 and cell.config["model"]["M"] == 100
    assert {m["name"] for m in cell.per_layer} == expect
    assert all(C.reader(str(tmp_path), m["name"]) in READERS for m in cell.per_layer)
    mix = C.make_mix(cell, 1, torch.device("cpu"))
    if shared:
        assert mix.mix["batch_size"] == 256 and mix.unit_flops() > 0
    else:
        assert mix.args[:3] == (cell.config, cell.traffic, 1)
    assert all(p.read_bytes() == b for p, b in before.items())
    with pytest.raises(KeyError):
        C.load(str(tmp_path), "no_such.cell")


def test_operator_costs_by_hand():
    # K1 / K2: H O M^2 D operations; z, invs, gamma2 read, the Gram written
    assert costs.operator_cost("vargp_torch::sym_gram", [[2, 3, 4], [5, 4], [5]]) == (
        5 * 2 * 3 * 3 * 4, 4 * (24 + 20 + 5 + 90))
    assert costs.operator_cost("vargp_torch::sym_gram_tri", [[2, 3, 4], [5, 4], [5]])[0] == 360
    # K4: 2 H O M B D
    assert costs.operator_cost("vargp_torch::cross_gram", [[2, 3, 4], [6, 4], [5, 4], [5]]) == (
        2 * 5 * 2 * 3 * 6 * 4, 4 * (24 + 24 + 20 + 5 + 180))
    # K3 on (4, 8, 8) blocks: 4 * 8^3 / 3 operations, the lower triangle
    # read and the factor written
    assert costs.operator_cost("vargp_torch::diag_chol", [[4, 8, 8]]) == (682, 4 * 4 * (36 + 64))
    assert costs.operator_cost("vargp_torch::chol_inv", [[2, 6, 6]]) == (2 * 2 * 216 // 3,
                                                                         4 * 2 * (21 + 72))
    assert costs.operator_cost("aten::mm", [[2, 2], [2, 2]]) is None
    # a call of 1.65e9 operations and 3.35e6 bytes: 10 us by operations
    assert costs.bound_s(1.65e9, 3.35e6) == pytest.approx(1e-5)
    assert costs.bound_s(1.0, 3.35e9) == pytest.approx(1e-3)


def test_model_flops_by_hand():
    cfg = dict(model=dict(out_size=2, M=3, in_size=4, n_var_samples=2), task=1)
    # H = 2, O = 2 (G = 4), T = 2, S = 6, c = 3, B = 5
    forward = (4 * 36 * 4 + 2 * 4 * 6 * 5 * 4 + 4 * 216 // 3 + 4 * 36 * 5 + 4 * 2 * 9
               + 4 * 2 * 27 + 2 * 4 * 6 * 5 + 2 * 4 * 2 * 9 * 5)
    # a call that draws anew, and builds the chain posterior, each time
    assert costs.predict_call_flops(cfg, 2, 5, 1) == forward
    kl = 2 * 2 * 4 * 3 * 3 + 2 * 2 * 4 * 3 * 3 + 4 * 27 + 2 * 4 * 9
    assert costs.train_step_flops(cfg, 5) == 3 * (forward + kl)


@pytest.mark.parametrize("name,call,posterior,passes_per_call", [
    ("pmnist_final.predict", 283.648, 225.4866667, 10 / 200),
    ("smnist_final.predict", 61.1328, 16.1316, 5 / 21)])
def test_a_predict_call_counts_the_posterior_once_a_pass(name, call, posterior, passes_per_call):
    # H = 20, B = 512; P-MNIST's ten splits of 10,000 rows take 20 calls
    # each, S-MNIST's five take 5, 4, 4, 4, 4
    cfg = C.load(ROOT, name).config
    assert sum(costs.call_terms(cfg, 20, 512).values()) / 1e9 == pytest.approx(call)
    assert sum(costs.posterior_terms(cfg, 20).values()) / 1e9 == pytest.approx(posterior)
    mix = C.make_mix(C.load(ROOT, name), 1, torch.device("cpu"))
    assert mix.unit_flops() / 1e9 == pytest.approx(call + posterior * passes_per_call)


def test_the_predict_window_is_whole_passes(tiny_cell, monkeypatch):
    """A stub ``predict`` on a stub clock: a pass's first call takes 5 ms,
    each other 1 ms.  Splits of 50, 20 and 70 rows in batches of 32 take
    2, 1 and 3 calls: passes end at 6, 11, 18 and 24 ms, so a window of
    20 ms ends at 24 ms, after the fourth pass's second call."""
    cell = tiny_cell("predict")
    cell.config = dict(cell.config, test_splits={"permuted": False, "rows": [50, 20, 70]})
    mix = C.make_mix(cell, 2**31 + 7, torch.device("cpu"))
    mix.setup()
    clock, last = [0.0], [None]

    def call(noise, xb):
        clock[0] += 1e-3 if noise is last[0] else 5e-3
        last[0] = noise
        return np.full((len(xb), 3), 1 / 3)

    monkeypatch.setattr(mix, "_call", call)
    monkeypatch.setitem(type(mix).window.__globals__, "time",
                        types.SimpleNamespace(perf_counter=lambda: clock[0]))
    win = mix.window(0.020)
    calls = mix.calls[:mix.n_window]
    assert [(k, s, b) for k, s, b, _, _ in calls] == [
        (0, 0, 0), (0, 0, 1), (1, 1, 0), (2, 2, 0), (2, 2, 1), (2, 2, 2), (3, 0, 0), (3, 0, 1)]
    lat = np.array([c[3] for c in calls]) * 1e3
    assert win["attempted"] == 8 and win["failed"] == 0
    assert win["metrics"]["predict_ms_p99"] == np.percentile(lat, 99)
    assert win["metrics"]["predict_ms_p95"] == np.percentile(lat, 95)
    # real rows only: the padded rows of each split's last batch do not count
    assert win["metrics"]["predict_rows_per_s"] == pytest.approx((50 + 20 + 70 + 50) / 0.024)
    # the traced slice still stops at its count of calls, mid-pass or not
    assert mix.traced() == 3 and len(mix.calls) == 8 + 3


def _slice():
    s = trace.Slice(t0=0, t1=100, units=2)
    s.device = [trace.DeviceEvent("k_gemm", 10, 30, 7), trace.DeviceEvent("k_mine", 20, 40, 8),
                trace.DeviceEvent("Memcpy HtoD", 60, 70, 0)]
    s.host = [trace.HostEvent("outer", 0, 100, 1, []), trace.HostEvent("cudaLaunchKernel", 38, 58, 2, []),
              trace.HostEvent("vargp_torch::sym_gram", 5, 25, 8, [[2, 3, 4], [5, 4], [5]])]
    s.ops = {8: s.host[2], 1: s.host[0]}
    return s


def test_slice_arithmetic():
    s = _slice()
    assert trace.busy_intervals(s) == [(10, 40), (60, 70)]
    assert trace.busy_s(s) == pytest.approx(40e-9)
    assert trace.device_ops(s)[0] == ["k_gemm", 20e-9]
    # gaps: [0, 10) and [70, 100) inside "outer", [40, 60) in the launch call
    gaps = dict(trace.idle_gaps(s))
    assert gaps == {"outer": pytest.approx(40e-9), "cudaLaunchKernel": pytest.approx(20e-9)}
    assert trace.operator_calls(s) == [("vargp_torch::sym_gram", [[2, 3, 4], [5, 4], [5]], 20)]
    assert trace.library_products_ns(s) == 20


def test_readers_read_the_slice_and_return_nothing_when_nothing_is_there():
    s = _slice()
    ctx = C.Context(slice=s, ops_slice=s, rate=10.0, unit_flops=3.3e12, config={}, traffic={})
    assert readers.launches_per_unit(ctx) == 1.5
    assert readers.products_ms_per_unit(ctx) == pytest.approx(1e-5)
    # 40 ns busy of the slice's 100
    assert readers.idle_share(ctx) == pytest.approx(60.0)
    bound = costs.bound_s(*costs.operator_cost("vargp_torch::sym_gram", [[2, 3, 4], [5, 4], [5]]))
    assert readers.kernels_roofline(ctx) == pytest.approx(100 * bound / 20e-9)
    # 3.3 TFLOP a unit, 10 units a second, over 165 TFLOP/s
    assert readers.mfu(ctx) == pytest.approx(20.0)
    empty = C.Context(slice=trace.Slice(0, 100, 2), ops_slice=trace.Slice(0, 100, 2), rate=0.0,
                      unit_flops=3.3e12, config={}, traffic={})
    for read in READERS:
        assert read(empty) is None


@pytest.mark.parametrize("name", [m["name"] for m in _bench()["per_layer"]])
def test_each_metric_file_binds_the_reader_of_its_quantity(name):
    quantity = {"launches_per_call": readers.launches_per_unit,
                "products_ms_per_call": readers.products_ms_per_unit,
                "kernels_roofline": readers.kernels_roofline,
                "idle_share": readers.idle_share, "mfu": readers.mfu,
                "predict_host_ms": spans.predict_host_ms,
                "predict_idle_share": spans.predict_idle_share,
                "posterior_device_ms": spans.posterior_device_ms}
    assert C.reader(ROOT, name) is quantity[name.split(".", 1)[0]]


def test_result_line_keys(tiny_cell):
    from benchmark import run

    result, lines = run.run_cell(tiny_cell("predict"), 7, 0.2, False, torch.device("cpu"), 0.0)
    assert list(result) == RESULT_KEYS
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["metrics"]) == {"predict_rows_per_s.tiny", "predict_ms_p95.tiny",
                                      "predict_ms_p99.tiny", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in result["metrics"].values())
    assert set(result["compared"]) == {"probs"} and len(lines) == 1
    assert "limit" in lines[0]


def test_no_card_means_no_result(capsys):
    from benchmark import run

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    assert run.main(["--workload", "pmnist_final.predict", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def _python(code: str, cwd: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_no_jax_or_jax_package_in_the_harness_or_the_reference():
    code = (
        "import sys; sys.path.insert(0, '.');"
        "import benchmark.run, benchmark.readings, benchmark.port;"
        "from benchmark import cell as C;"
        "[C.reader('.', m['name']) for m in __import__('json').load(open('BENCHMARK.json'))"
        "['per_layer']];"
        "[C.kind('.', k) for k in ('train', 'predict')];"
        "benchmark.port.port_modules();"
        "print(sorted({m.split('.', 1)[0] for m in sys.modules}"
        " & {'jax', 'jaxlib', 'flax', 'vargp_tpu'}))"
    )
    out = _python(code, ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    ref = _python("import sys; sys.path.insert(0, '.'); import benchmark.reference.vargp;"
                  "print(sorted(m for m in sys.modules if m.split('.', 1)[0].startswith('vargp')"
                  " or m.split('.', 1)[0] in ('jax', 'jaxlib', 'flax')))", ROOT)
    assert ref.returncode == 0, ref.stderr
    assert ref.stdout.strip() == "[]"


def test_the_forbidden_check_compares_whole_top_level_names(monkeypatch):
    from benchmark import run

    for name in list(sys.modules):
        if name.split(".", 1)[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "vargp_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "vargp_tpu.models", sys)
    assert run.forbidden_modules() == ["vargp_tpu"]


def test_a_directory_with_only_the_benchmark_prints_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "smnist_final.predict",
                          "--seed", "3", "--seconds", "1"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in _bench()["workloads"]])
def test_each_cell_runs_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                          "2147483659", "--seconds", "2", "--trace", "1"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["compared"]
    assert result["device"]["busy_s"] > 0
