"""The global continual SVGP's drivers (``experiments/global_run.py``:
``toy_global``, ``split_mnist``, ``permuted_mnist``) and analyses
(``analyze_smnist_global``, ``analyze_toy_global``) on the CPU at tiny
sizes: two tasks each, M growing; both analyses on a tiny saved chain
against the JAX package's on its own draws (replayed through the port's
draw seam: the same accuracies, entropies and retention within 1e-6, the
toy's grid within 1e-5); and every global entry point's refusal to run
without a card unless asked for the CPU.  Permuted-MNIST runs on a cut of
the surrogate (1,000 training rows, the 10,000 validation rows, 1,000
test rows): its cross Gram broadcasts each batch over the 10 classes, and
the whole surrogate takes a minute here."""

import json
import os

import numpy as np
import jax
import pytest
import torch

from vargp_tpu.experiments import analysis as JA
from vargp_tpu_torch import data as tdata
from vargp_tpu_torch.experiments import analysis as TA
from vargp_tpu_torch.experiments import global_run as GR


# ---------------------------------------------------------------------------
# The global SVGP: drivers, analyses, entry points
# ---------------------------------------------------------------------------

TOY_GLOBAL = dict(epochs=4, M=3, eval_interval=2, batch_size=64, seed=0, n_f=3,
                  n_var_samples=2, device="cpu")
TINY_GLOBAL = dict(epochs=1, M=4, eval_interval=1, batch_size=4096, seed=0, n_f=2,
                   n_var_samples=1, patience=-1, n_tasks=2, device="cpu")


def _check_global_run(log_dir, params, summaries, n_tasks, Ms):
    assert len(summaries) == n_tasks
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    tags = {r["tag"] for r in rows}
    for t in range(n_tasks):
        with np.load(os.path.join(log_dir, f"ckpt{t}.npz")) as ck:
            assert ck[".z"].shape[1] == Ms[t]
        assert {f"task{t}/loss/u_prev_reg", f"task{t}/val/acc"} <= tags
        assert 0.0 <= summaries[t][f"task{t}/test/acc"] <= 1.0
    assert all(np.isfinite(r["value"]) for r in rows)
    assert tuple(params.z.shape[-2:]) == (Ms[-1], params.z.shape[-1])


def test_toy_global_driver_two_tasks(tmp_path):
    """toy_global on the CPU: two tasks of a few epochs, M growing 3 -> 6,
    evaluations at epochs 2 and 4, u_prev_reg 0 at task 0 and live at
    task 1, task 1 regularised by task 0's saved parameters."""
    params, summaries = GR.toy_global(log_dir=str(tmp_path), **TOY_GLOBAL)
    _check_global_run(str(tmp_path), params, summaries, 2, [3, 6])
    with open(tmp_path / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows if r["tag"] == "task1/val/acc"] == [2, 4]
    reg = {r["tag"].split("/")[0]: r["value"] for r in rows if r["tag"].endswith("u_prev_reg")}
    assert reg["task0"] == 0.0 and reg["task1"] != 0.0


@pytest.mark.parametrize("driver", ["s_mnist_global", "p_mnist_global"])
def test_global_mnist_drivers_tiny(tmp_path, monkeypatch, driver):
    """One epoch of two tasks on the MNIST surrogate (Permuted-MNIST on
    its cut), the second growing by 2 rows a class."""
    kw = dict(TINY_GLOBAL, log_dir=str(tmp_path), grow_per_task=2)
    fn = GR.split_mnist if driver == "s_mnist_global" else GR.permuted_mnist
    if driver == "p_mnist_global":
        load = tdata.load_mnist
        monkeypatch.setattr(tdata, "load_mnist", lambda data_dir=None, train=True: load(
            data_dir, train).select(np.arange(11000 if train else 1000)))
    params, summaries = fn(**kw)
    _check_global_run(str(tmp_path), params, summaries, 2, [4, 6])


def _jax_cell_draws(key, cfg_eval, B):
    """The draws a JAX analysis's ``predict`` makes from ``key``, as the
    port's noise: hyper_eps (n_v, D+1), lik_eps (H, n_f, O, B)."""
    k_fwd, k_lik = jax.random.split(key)
    H = cfg_eval.n_var_samples
    t = lambda a: torch.tensor(np.asarray(a))
    return {"hyper_eps": t(jax.random.normal(k_fwd, (H, cfg_eval.in_size + 1))),
            "lik_eps": t(jax.random.normal(k_lik, (H, cfg_eval.n_f, cfg_eval.out_size, B)))}


def _replay(monkeypatch, draws):
    """Make the port's analysis take ``draws`` (an iterator of noise dicts)
    in place of its generator's."""
    monkeypatch.setattr(TA, "eval_draws", lambda gen, cfg, n, B: iter([next(draws)]))


def test_analyze_smnist_global_replays_the_jax_analysis(tmp_path, monkeypatch):
    """A tiny two-task global chain (M = 4, then 6) analysed by the port on
    the JAX ``analyze_smnist_global``'s own draws (one key a cell, every
    batch of the cell on it): the same accuracy matrix, entropies within
    1e-6; the port writes analysis_torch.json and leaves analysis.json to
    the JAX package."""
    GR.split_mnist(**dict(TINY_GLOBAL, log_dir=str(tmp_path), grow_per_task=2))
    kw = dict(n_tasks=2, M=4, grow_per_task=2, n_f=3, n_var_samples=2)
    want = JA.analyze_smnist_global(str(tmp_path), **kw)
    from vargp_tpu_torch.models.global_svgp import GlobalSVGPConfig

    def jax_draws():
        key = jax.random.key(0)
        for t in range(2):
            cfg_eval = GlobalSVGPConfig(M=4 + 2 * t, out_size=10, in_size=784, n_f=3,
                                        n_var_samples=2)
            for _ in range(2):
                key, k = jax.random.split(key)
                yield _jax_cell_draws(k, cfg_eval, 512)

    _replay(monkeypatch, jax_draws())
    got = TA.analyze_smnist_global(str(tmp_path), device="cpu", **kw)
    assert np.array_equal(got["acc_matrix"], want["acc_matrix"])
    np.testing.assert_allclose(got["ent_matrix"], want["ent_matrix"], rtol=0, atol=1e-6)
    assert os.path.exists(tmp_path / "analysis_torch.json")


def test_analyze_toy_global_replays_the_jax_analysis(tmp_path, monkeypatch):
    """A two-task toy_global chain (M = 3, then 6) analysed by the port on
    the JAX ``analyze_toy_global``'s draws (per task: the grid's key, then
    the retention's): retention within 1e-6, the grid's probabilities
    within 1e-5, each grid point a distribution."""
    GR.toy_global(log_dir=str(tmp_path), **TOY_GLOBAL)
    kw = dict(M=3, n=20, n_f=4, n_var_samples=3)
    want = JA.analyze_toy_global(str(tmp_path), **kw)
    want_grid = np.load(tmp_path / "density_grid.npz")["probs"]
    from vargp_tpu_torch.data import filter_by_class, make_toy_dataset
    from vargp_tpu_torch.models.global_svgp import GlobalSVGPConfig

    n0 = len(filter_by_class(make_toy_dataset(seed=0), [0, 1]))

    def jax_draws():
        key = jax.random.key(0)
        for t in range(2):
            cfg_eval = GlobalSVGPConfig(M=3 * (t + 1), out_size=4, in_size=2, n_f=4,
                                        n_var_samples=3)
            key, k_grid, k_ret = jax.random.split(key, 3)
            yield _jax_cell_draws(k_grid, cfg_eval, 400)
            yield _jax_cell_draws(k_ret, cfg_eval, n0)

    _replay(monkeypatch, jax_draws())
    got = TA.analyze_toy_global(str(tmp_path), device="cpu", **kw)
    np.testing.assert_allclose(got["density_retention"], want["density_retention"], rtol=0,
                               atol=1e-6)
    grid = np.load(tmp_path / "density_grid_torch.npz")["probs"]
    assert grid.shape == want_grid.shape == (2, 20, 20, 4)
    np.testing.assert_allclose(grid, want_grid, rtol=0, atol=1e-5)
    np.testing.assert_allclose(grid.sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("entry", ["toy_global", "s_mnist_global", "p_mnist_global",
                                   "analyze_toy_global", "analyze_smnist_global"])
def test_global_entry_points_need_a_card_unless_asked(tmp_path, entry):
    """Each global entry point raises with no card unless given
    device='cpu', before it loads data or writes a file."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None would run on it")
    fn = {"toy_global": GR.toy_global, "s_mnist_global": GR.split_mnist,
          "p_mnist_global": GR.permuted_mnist, "analyze_toy_global": TA.analyze_toy_global,
          "analyze_smnist_global": TA.analyze_smnist_global}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry.startswith("analyze"):
            fn(str(tmp_path))
        else:
            fn(log_dir=str(tmp_path))
    assert not os.listdir(tmp_path)
