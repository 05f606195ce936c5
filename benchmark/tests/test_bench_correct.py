"""What decides ``correct``, on the CPU at a tiny size: the reference
agrees with the port, the TF32 control does not, and a run whose timed
path is broken underneath comes out not correct, once per fault the mix
can have."""

import os

import pytest
import torch

from benchmark import cell as C
from benchmark import readings, run
from benchmark.reference import vargp as R

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CPU = torch.device("cpu")
KINDS = {k: C.kind(ROOT, k) for k in ("train", "predict")}


@pytest.mark.parametrize("kind", ["train", "predict"])
def test_the_port_agrees_with_the_reference(tiny_cell, kind):
    result, _ = run.run_cell(tiny_cell(kind), 2**31 + 11, 0.3, False, CPU, 0.0)
    assert result["correct"], result["compared"]
    for v in result["compared"].values():
        assert v["value"] < v["limit"] / 10


@pytest.mark.parametrize("kind", ["train", "predict"])
def test_the_control_is_not_correct(tiny_cell, kind):
    cell = tiny_cell(kind)
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        r = readings.reading(cell, seed, 0.2 if kind == "predict" else 0, CPU, control=True)
        assert not run.check.verdict(r["control"], cell.limits), r
        assert run.check.verdict(r["numbers"], cell.limits), r


@pytest.mark.parametrize("kind,fault", [(k, f) for k, m in KINDS.items() for f in m.FAULTS])
def test_a_broken_timed_path_is_not_correct(tiny_cell, kind, fault):
    with KINDS[kind].FAULTS[fault]():
        result, _ = run.run_cell(tiny_cell(kind), 2**31 + 5, 0.3, False, CPU, 0.0)
    assert not result["correct"], result["compared"]


def test_faults_restore_the_program():
    from vargp_tpu_torch.models import vargp as V
    from vargp_tpu_torch.train import loop as TL

    step, predict = TL.elbo_step, V.predict
    for kind in KINDS.values():
        for fault in kind.FAULTS.values():
            with fault():
                assert (TL.elbo_step, V.predict) != (step, predict)
    assert (TL.elbo_step, V.predict) == (step, predict)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0000002], dtype=torch.float32)
    got = R.tf32_round(x)
    assert got[0] == 1.0 and got[2] == 1.0 + 2 ** -10
    assert got[3] == -3.0
    assert torch.all((got.view(torch.int32) & 0x1FFF) == 0)
