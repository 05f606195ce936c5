"""The port's Retrain driver (``experiments/retrain_run.py``: ``toy``, its
``train_task``, train block and evaluation) against the JAX package's
``retrain_run.toy`` on the CPU, the JAX keys replayed through the port's
draw seam (``tests/_torch_cases.py::JaxRetrainDraws``: the inducing rows,
the initial parameters, every block's permutations and loss draws, every
evaluation's draws and the final accuracy's).

Two tasks of the toy at a few epochs (M = 3, batches of 64 rows: two
steps an epoch, an evaluation every 2 epochs): every logged accuracy
equal, the final accuracies equal, the final parameters within 1e-5,
the checkpoints' keys and structure strings equal to the JAX run's.
"""

import json
import os

import numpy as np
import jax
import pytest
import torch

from tests import _torch_cases as C
from vargp_tpu.experiments import retrain_run as JRR
from vargp_tpu_torch.experiments import cli
from vargp_tpu_torch.experiments import retrain_run as TRR
from vargp_tpu_torch.train.optim import tree_leaves

TOY = dict(epochs=4, M=3, eval_interval=2, batch_size=64, seed=0, n_f=3, n_var_samples=2)
ATOL_PARAMS = 1e-5


def _rows(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [(r["tag"], r["step"], r["value"]) for r in map(json.loads, f)]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_retrain"))
    params, summaries = JRR.toy(log_dir=d, **TOY)
    return d, params, summaries


def test_toy_replays_the_jax_driver(jax_run, tmp_path):
    """The port's toy on the JAX driver's draws: the same log (tags, epochs,
    accuracies), the same final accuracies, final parameters within 1e-5,
    and checkpoints with the JAX run's keys, shapes and structure."""
    jdir, jparams, jsum = jax_run
    params, summaries = TRR.toy(log_dir=str(tmp_path), device="cpu",
                                task_draws=C.jax_retrain_task_draws(TOY["seed"]), **TOY)
    want = _rows(jdir)
    assert [(t, s) for t, s, _ in want] == [(f"task{k}/test/acc", e) for k in (0, 1)
                                            for e in (2, 4)]
    assert _rows(str(tmp_path)) == want
    assert summaries == jsum
    leaves = jax.tree_util.tree_leaves(jparams)
    assert len(tree_leaves(params)) == len(leaves) == 8
    for g, w in zip(tree_leaves(params), leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL_PARAMS)
    for t in (0, 1):
        with np.load(os.path.join(jdir, f"ckpt{t}.npz")) as a, \
                np.load(tmp_path / f"ckpt{t}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            assert all(a[k].shape == b[k].shape for k in a.files)
        structs = [json.load(open(os.path.join(p, f"ckpt{t}.npz.structure.json")))["treedef"]
                   for p in (jdir, str(tmp_path))]
        assert structs[0] == structs[1]


def test_draws_follow_the_generator_and_the_task(tmp_path):
    """Without a draw source the run draws from task_generator(seed, t): two
    runs of the same seed give bitwise equal parameters and logs; the
    dataset is the 4-cluster toy of seed 0 whatever the run's seed."""
    kw = dict(TOY, epochs=2, device="cpu")
    a, sa = TRR.toy(log_dir=str(tmp_path / "a"), **kw)
    b, sb = TRR.toy(log_dir=str(tmp_path / "b"), **kw)
    assert sa == sb and _rows(str(tmp_path / "a")) == _rows(str(tmp_path / "b"))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    c, _ = TRR.toy(log_dir=str(tmp_path / "c"), **dict(kw, seed=7))
    assert not torch.equal(a.kernel.log_mean, c.kernel.log_mean)
    assert len(a.tasks) == 2 and tuple(a.tasks[1].z.shape) == (4, 3, 2)


def test_cli_runs_toy_retrain(tmp_path, capsys):
    """``python -m vargp_tpu_torch toy_retrain`` goes to ``retrain_run.toy``:
    both tasks' checkpoints and their final accuracies printed."""
    assert cli.main(["toy_retrain", "--epochs=2", "--M=3", "--eval_interval=2",
                     "--batch_size=64", "--n_f=2", "--n_var_samples=1", "--seed=1",
                     "--device=cpu", f"--log_dir={tmp_path}"]) == 0
    out = capsys.readouterr().out
    assert "[toy_retrain] task 1: test acc" in out
    assert (tmp_path / "ckpt0.npz").exists() and (tmp_path / "ckpt1.npz").exists()
