"""Device-time profiling (``utils/profiling.py``), the counterpart of the
JAX package's trace parser (``tests/test_utils.py``'s parse_trace cases):
an empty directory parses to nothing; in a synthetic ``torch.profiler``
chrome trace only the device's kernel events count, copies and fills
under their own names, and none of the host's rows (CPU ops, Python
functions, CUDA runtime calls); ``profile_fn`` on the CPU profiles the
CPU ops by their own time.  The card's profile runs in ``chip_smoke.py``.
"""

import gzip
import json

import pytest
import torch

from vargp_tpu_torch.utils.profiling import parse_trace, profile_fn


def test_parse_trace_empty(tmp_path):
    assert parse_trace(str(tmp_path)) == {}
    assert parse_trace(str(tmp_path), counts=True) == ({}, {})


def _trace():
    """A chrome trace as torch.profiler writes it: a host thread with a
    CPU op calling another, a Python function and a runtime launch, and a
    device stream with two kernels, a copy and a fill."""
    return {"traceEvents": [
        {"ph": "X", "cat": "python_function", "name": "chip_smoke.py(10): step", "pid": 1,
         "tid": 1, "ts": 0, "dur": 500},
        {"ph": "X", "cat": "cpu_op", "name": "aten::matmul", "pid": 1, "tid": 1, "ts": 10,
         "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1, "ts": 20, "dur": 60},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
         "ts": 30, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "sym_gram_kernel(float const*, int)", "pid": 0,
         "tid": 7, "ts": 40, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "sym_gram_kernel(float const*, int)", "pid": 0,
         "tid": 7, "ts": 200, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "volta_sgemm_128x64_nn", "pid": 0, "tid": 7,
         "ts": 300, "dur": 30},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "pid": 0,
         "tid": 7, "ts": 400, "dur": 8},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "pid": 0, "tid": 7,
         "ts": 420, "dur": 2},
        {"ph": "i", "cat": "kernel", "name": "instant", "pid": 0, "tid": 7, "ts": 430},
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
    ]}


@pytest.mark.parametrize("gz", [False, True])
def test_parse_trace_counts_device_events_only(tmp_path, gz):
    path = tmp_path / ("run.pt.trace.json.gz" if gz else "trace.json")
    if gz:
        with gzip.open(path, "wt") as f:
            json.dump(_trace(), f)
    else:
        path.write_text(json.dumps(_trace()))
    for where in (str(path), str(tmp_path)):  # the file, or its directory
        ms, n = parse_trace(where, counts=True)
        assert ms == {"sym_gram_kernel(float const*, int)": 0.15, "volta_sgemm_128x64_nn": 0.03,
                      "Memcpy HtoD (Pageable -> Device)": 0.008, "Memset (Device)": 0.002}
        assert n == {"sym_gram_kernel(float const*, int)": 2, "volta_sgemm_128x64_nn": 1,
                     "Memcpy HtoD (Pageable -> Device)": 1, "Memset (Device)": 1}
    assert parse_trace(str(path), categories=("kernel",)) == {
        "sym_gram_kernel(float const*, int)": 0.15, "volta_sgemm_128x64_nn": 0.03}


def test_parse_trace_own_time_subtracts_nested_host_ops(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(_trace()))
    got = parse_trace(str(path), categories=("cpu_op",), own_time=True)
    assert got == pytest.approx({"aten::matmul": 0.04, "aten::mm": 0.06})


def test_profile_fn_on_the_cpu():
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    out = profile_fn(lambda: torch.relu(a @ b), iters=3, top=5, device="cpu")
    assert set(out) == {"top", "events_per_call", "launches_per_call", "busy_ms", "spans"}
    assert out["spans"] == {}  # the function opens no span
    assert len(out["top"]) <= 5 and "aten::mm" in out["launches_per_call"]
    assert out["launches_per_call"]["aten::mm"] == 1.0
    assert out["events_per_call"] >= 2 and out["busy_ms"] > 0
    assert all(v >= 0 for v in out["top"].values())
    assert list(out["top"].values()) == sorted(out["top"].values(), reverse=True)


def test_device_trace_keeps_the_trace_only_where_asked(tmp_path, monkeypatch):
    """Without a log_dir the trace goes to a temporary directory that is
    removed; with one it stays there.  Either way the block's CPU ops come
    back parsed, by name and as events."""
    import tempfile

    from vargp_tpu_torch.utils.profiling import device_trace

    scratch = tmp_path / "tmp"
    scratch.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(scratch))
    a = torch.randn(32, 32)
    with device_trace(device="cpu") as tr:
        a @ a
    assert "aten::mm" in tr["events"] and any(e["name"] == "aten::mm" for e in tr["trace"])
    assert list(scratch.iterdir()) == []
    with device_trace(str(tmp_path / "kept"), device="cpu") as tr:
        a @ a
    assert (tmp_path / "kept" / "trace.json").is_file()
    assert parse_trace(str(tmp_path / "kept"), categories=("cpu_op",), own_time=True) == tr["events"]


def test_profile_fn_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_fn(lambda: None)
