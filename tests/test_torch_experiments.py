"""The port's experiment drivers, command line and toy analysis on the
CPU, at tiny sizes as tests/test_experiments.py runs the JAX package's:
every driver end to end, a resumed run against an uninterrupted one
(bitwise), the sweep's read-back, the command table and its refusals,
a chain written by the port read by the JAX package, and the toy chain
``results/toy_full`` reloaded (within the JAX analysis's own spread over
evaluation keys)."""

import json
import os
import subprocess
import sys
from dataclasses import replace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vargp_tpu.experiments import vargp_run as JR
from vargp_tpu.models import vargp as JV
from vargp_tpu.utils.checkpoint import load_chain as jload_chain
from vargp_tpu_torch.experiments import analysis as TA
from vargp_tpu_torch.experiments import cli
from vargp_tpu_torch.experiments import vargp_run as R
from vargp_tpu_torch.train.optim import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(epochs=1, M=4, eval_interval=1, batch_size=4096, seed=0, n_f=2, n_var_samples=1,
            patience=-1, n_tasks=2, device="cpu")
TOY = dict(epochs=4, M=6, eval_interval=2, batch_size=128, seed=0, n_tasks=2, device="cpu")


def _check_run(log_dir, chain, summaries, n_tasks=2):
    assert len(chain) == len(summaries) == n_tasks
    for t in range(n_tasks):
        assert os.path.exists(os.path.join(log_dir, f"ckpt{t}.npz"))
        acc = summaries[t][f"task{t}/test/acc"]
        assert 0.0 <= acc <= 1.0
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert {r["tag"] for r in rows} >= {f"task{t}/val/acc_best" for t in range(n_tasks)}
    assert all(np.isfinite(r["value"]) for r in rows)


def test_toy_driver_tiny(tmp_path):
    chain, summaries = R.toy(log_dir=str(tmp_path), **TOY)
    _check_run(str(tmp_path), chain, summaries)


@pytest.mark.parametrize("driver", ["s_mnist", "p_mnist", "p_mnist padded", "s_digits"])
def test_drivers_tiny(tmp_path, driver):
    """One epoch of two tasks on the MNIST surrogate (Permuted-MNIST with
    a growing chain and with the chain padded) and on the real digits."""
    kw = dict(TINY, log_dir=str(tmp_path))
    if driver == "s_mnist":
        out = R.split_mnist(**kw)
    elif driver == "s_digits":
        out = R.split_digits(**dict(kw, batch_size=256, M=8))
    else:
        out = R.permuted_mnist(padded_chain=driver.endswith("padded"), **kw)
    _check_run(str(tmp_path), *out)
    with open(tmp_path / "run_meta.json") as f:
        assert "data_source" in json.load(f)


def test_resumed_run_is_bitwise_the_uninterrupted_one(tmp_path):
    """Task 1's checkpoint removed (a run cut after task 0), then
    ``resume=True``: task 0 reloads, task 1 trains again from its own
    generator, and the chain equals an uninterrupted run's bit for bit."""
    whole, _ = R.toy(log_dir=str(tmp_path / "a"), **TOY)
    R.toy(log_dir=str(tmp_path / "b"), **TOY)
    os.remove(tmp_path / "b" / "ckpt1.npz")
    resumed, summaries = R.toy(log_dir=str(tmp_path / "b"), resume=True, **TOY)
    assert summaries[0] == {} and summaries[1]
    for p, q in zip(whole, resumed):
        for a, b in zip(tree_leaves(p), tree_leaves(q)):
            assert torch.equal(a, b)


def test_port_chain_loads_in_the_jax_package(tmp_path):
    """ckpt{t}.npz written by the port's driver, read by the JAX
    ``load_chain`` against its own template: every leaf bitwise."""
    chain, _ = R.toy(log_dir=str(tmp_path), **TOY)
    cfg = JV.VARGPConfig(M=TOY["M"], out_size=4, in_size=2)
    template, _ = JV.init_params(jax.random.key(0), jnp.zeros((4, TOY["M"], 2)), cfg)
    loaded = jload_chain(str(tmp_path), 2, [template, template])
    for p, q in zip(chain, loaded):
        got, want = tree_leaves(p), jax.tree_util.tree_leaves(q)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_completed_sweep_acc_readback_matches_jax(tmp_path):
    m_dir = tmp_path / "M20"
    m_dir.mkdir()
    rows = [
        {"tag": "task0/test/acc_best", "value": 0.5, "step": 10},
        {"tag": "task1/test/acc_best", "value": 0.7, "step": 10},
        {"tag": "task1/test/acc_best", "value": 0.9, "step": 20},
    ]
    with open(m_dir / "metrics.jsonl", "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
        f.write("not json\n")
    for n_tasks, want in ((2, 0.9), (3, None)):
        assert R._completed_sweep_acc(str(m_dir), n_tasks) == want
        assert JR._completed_sweep_acc(str(m_dir), n_tasks) == want
    assert R._completed_sweep_acc(str(tmp_path / "M40"), 2) is None


def test_varying_m_refuses_to_record_zero(tmp_path, monkeypatch):
    """A point whose final summary is empty (every task reloaded) reads its
    metric back from its metrics file, or raises; never 0.0."""
    monkeypatch.setattr(R, "split_digits", lambda **kw: ([], [{}]))
    with pytest.raises(RuntimeError, match="refusing"):
        R.varying_m(ms=(4,), dataset="s_digits", n_tasks=2, log_dir=str(tmp_path))
    with open(tmp_path / "M4" / "metrics.jsonl", "w") as f:
        f.write(json.dumps({"tag": "task1/test/acc_best", "value": 0.9}) + "\n")
    r = R.varying_m(ms=(4,), dataset="s_digits", n_tasks=2, log_dir=str(tmp_path))
    assert r == {4: 0.9}
    with open(tmp_path / "varying_M.json") as f:
        assert json.load(f) == {"4": 0.9}


def test_varying_m_resume_reads_back_a_finished_point(tmp_path):
    kw = dict(dataset="s_digits", epochs=2, eval_interval=1, batch_size=256, seed=0,
              patience=-1, n_tasks=2, log_dir=str(tmp_path), device="cpu")
    r1 = R.varying_m(ms=(4,), **kw)
    mtime = os.path.getmtime(tmp_path / "M4" / "metrics.jsonl")
    r2 = R.varying_m(ms=(4,), resume=True, **kw)
    assert r2 == r1
    assert os.path.getmtime(tmp_path / "M4" / "metrics.jsonl") == mtime


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------


def test_parse_args_as_the_jax_cli():
    argv = ["--epochs=5", "--lr=1e-3", "--dkl=True", "--name=abc", "--flag", "7"]
    assert cli._parse_args(argv) == ([7], dict(epochs=5, lr=1e-3, dkl=True, name="abc",
                                               flag=True))
    with pytest.raises(SystemExit, match="empty value"):
        cli._parse_args(["--log_dir="])


def test_command_table():
    cmds = cli._commands()
    assert set(cmds) == {"toy", "s_mnist", "p_mnist", "s_digits", "varying_m", "analyze_smnist",
                         "analyze_pmnist", "analyze_sdigits", "analyze_toy"}
    from vargp_tpu.experiments import cli as jcli

    assert set(cmds) | set(cli.NOT_PORTED) == set(jcli._commands())
    for name, fn in cmds.items():
        if not name.startswith("analyze_") and name != "varying_m":
            assert "device" in fn.__code__.co_varnames, name


def test_help_and_refusals(capsys):
    assert cli.main(["--help"]) == 0
    out = capsys.readouterr().out
    assert "s_mnist" in out and "--device" in out
    assert cli.main(["nonsense"]) == 1
    for name, item in cli.NOT_PORTED.items():
        assert cli.main([name]) == 2
        assert item in capsys.readouterr().err
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        cli.main(["toy", "--n_devices=2", "--device=cpu"])
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        cli.main(["toy", "--num_processes=2", "--device=cpu"])
    with pytest.raises(SystemExit, match="--device"):
        cli.main(["toy", "--platform=cpu"])


def test_module_entry_point_needs_a_card_unless_asked(tmp_path):
    """``python -m vargp_tpu_torch s_mnist`` with no card and no
    --device=cpu raises before any data is loaded; --help runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: s_mnist would train on it")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-m", "vargp_tpu_torch", "s_mnist",
                          f"--log_dir={tmp_path}"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert not os.listdir(tmp_path)
    res = subprocess.run([sys.executable, "-m", "vargp_tpu_torch", "--help"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "analyze_toy" in res.stdout


# ---------------------------------------------------------------------------
# The toy chain's reload
# ---------------------------------------------------------------------------


def _jax_retention_spread(log_dir, keys=12):
    """density_retention of the JAX ``analyze_toy`` under eval keys
    0..keys-1 (key 0 is the minted run's): (lowest, highest) per task."""
    cfg = JV.VARGPConfig(M=20, out_size=4, in_size=2)
    template, _ = JV.init_params(jax.random.key(0), jnp.zeros((4, 20, 2)), cfg)
    chain = jload_chain(log_dir, 2, [template, template])
    from vargp_tpu import data as jdata

    task0 = jdata.filter_by_class(jdata.make_toy_dataset(seed=0), [0, 1])
    cfg_eval = replace(cfg, n_f=100, n_var_samples=20)
    predict = jax.jit(JV.predict, static_argnames="cfg")
    out = np.zeros((keys, len(chain)))
    for s in range(keys):
        for t, p in enumerate(chain):
            prev = tuple(JV.freeze_task(q) for q in chain[:t])
            probs = np.asarray(predict(p, prev, jnp.asarray(task0.data),
                                       jax.random.fold_in(jax.random.key(s), 100 + t),
                                       cfg=cfg_eval))
            out[s, t] = np.mean(probs[np.arange(len(task0)), task0.targets])
    return out.min(axis=0), out.max(axis=0), out[0]


def test_analyze_toy_on_the_minted_chain(tmp_path):
    """``analyze_toy`` on results/toy_full (copied: the minted files stay
    untouched): the density retention lies within the JAX analysis's
    spread over 12 evaluation keys, whose key 0 gives the minted
    toy_density.json; the grid is a distribution at every point."""
    src = os.path.join(REPO, "results", "toy_full")
    for t in range(2):
        for ext in ("npz", "npz.structure.json"):
            with open(os.path.join(src, f"ckpt{t}.{ext}"), "rb") as f:
                (tmp_path / f"ckpt{t}.{ext}").write_bytes(f.read())
    lo, hi, key0 = _jax_retention_spread(str(tmp_path))
    with open(os.path.join(src, "toy_density.json")) as f:
        minted = json.load(f)
    np.testing.assert_allclose(key0, minted["density_retention"], rtol=1e-6)
    got = TA.analyze_toy(str(tmp_path), device="cpu")
    assert np.all(lo <= got["density_retention"]) and np.all(got["density_retention"] <= hi), (
        lo, hi, got["density_retention"])
    assert os.path.exists(tmp_path / "toy_density_torch.json")
    grid = np.load(tmp_path / "density_grid_torch.npz")
    assert grid["probs"].shape == (2, 60, 60, 4)
    np.testing.assert_allclose(grid["probs"].sum(-1), 1.0, atol=1e-4)
    assert not os.path.exists(tmp_path / "toy_density.json")


# ---------------------------------------------------------------------------
# Split-Digits, the whole protocol (slow)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_split_digits_seed0_protocol(tmp_path):
    """The port's Split-Digits run at seed 0 on the CPU and its analysis:
    the final average accuracy within 0.9454 +- 0.0188, two standard
    deviations of the JAX package's seeds 0-2 (0.9583, 0.9417, 0.9361,
    results/RESULTS.md).  Minutes on the CPU: marked slow."""
    R.split_digits(seed=0, log_dir=str(tmp_path), device="cpu")
    summary = TA.analyze_sdigits(str(tmp_path), device="cpu")
    assert abs(summary["final_avg_acc"] - 0.9454) <= 0.0188, summary["final_avg_acc"]
