"""The benchmark's own tests (``python -m pytest benchmark/tests -q``; the
repository's ``pytest tests/`` does not collect them).  A test that needs
the card is marked ``card`` and skips, decided inside the test, where
there is none.  ``tiny_cell`` builds a cell at a size the CPU runs in
seconds, with the port's plain kernels."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = dict(name="tiny", task=2, n_tasks=3,
            model=dict(M=8, out_size=3, in_size=16, n_var_samples=2, n_f=4, ep_var_mean=True,
                       jitter=1e-4),
            train=dict(batch_size=32, lr=3.7e-3, beta=1.64, optimizer="yogi",
                       max_steps_per_dispatch=128, pad_data_rows=100),
            train_rows=100, test_splits={"permuted": True, "rows": [50, 50, 50]})
# the tiny cell's limits: its sound runs read under a tenth of them on the
# CPU, the TF32 control and every fault above them
TINY_LIMITS = {"train": {"loss": 2e-5, "grad": 2e-5, "change": 1e-4}, "predict": {"probs": 1e-5}}
TINY_PREDICT = dict(batch_size=32, n_var_samples=3, n_f=5, trace_calls=3)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


def traffic(kind: str) -> dict:
    with open(os.path.join(ROOT, "benchmark", "traffic", f"{kind}.json")) as f:
        mix = json.load(f)
    return dict(mix, **TINY_PREDICT) if kind == "predict" else mix


@pytest.fixture
def tiny_cell():
    from benchmark import cell as C

    def make(kind: str):
        e2e = {"train": ["train_steps_per_s"],
               "predict": ["predict_rows_per_s.tiny", "predict_ms_p95.tiny",
                           "predict_ms_p99.tiny"]}
        return C.Cell(name=f"tiny.{kind}", chips=1, config=dict(TINY), traffic=traffic(kind),
                      limits=dict(TINY_LIMITS[kind]), root=ROOT,
                      end_to_end=[{"name": n, "unit": "u"} for n in e2e[kind] + ["setup_s"]])

    return make
