"""Sweeps (``experiments/sweep.py``) against the JAX package's: the spec
is the JAX spec but for ``program`` (this package's command line); the
sampler draws the JAX configurations from the same seeds; ``run_sweep``
runs the port's toy driver on the CPU (its runs under a temporary
``VARGP_TPU_LOGDIR``, nothing under ``runs/``) and refuses a seed in its
overrides as JAX does; the CLI's four new commands parse.
"""

import json

import numpy as np
import pytest

from vargp_tpu.experiments import sweep as JS
from vargp_tpu_torch.experiments import analysis as TA
from vargp_tpu_torch.experiments import cli
from vargp_tpu_torch.experiments import sweep as TS


def test_spec_equals_jax_but_for_the_program(tmp_path):
    jpath = JS.generate_vargp_sweep("s_mnist", out=str(tmp_path / "j.json"))
    tpath = TS.generate_vargp_sweep("s_mnist", out=str(tmp_path / "t.json"))
    j, t = (json.loads(open(p).read()) for p in (jpath, tpath))
    assert t.pop("program") == "python -m vargp_tpu_torch s_mnist"
    assert j.pop("program") == "python -m vargp_tpu s_mnist"
    assert t == j
    assert TS.DEFAULT_SPACE == JS.DEFAULT_SPACE


@pytest.mark.parametrize("seed", range(4))
def test_sample_draws_the_jax_configs(seed):
    a = JS._sample(JS.DEFAULT_SPACE, np.random.default_rng(seed))
    b = TS._sample(TS.DEFAULT_SPACE, np.random.default_rng(seed))
    assert a == b and list(a) == list(b)


def test_run_sweep_on_the_toy(tmp_path, monkeypatch):
    monkeypatch.setenv("VARGP_TPU_LOGDIR", str(tmp_path))
    res = TS.run_sweep("toy", n_trials=2, epochs=2, device="cpu")
    assert len(res) == 2 and res[0][0] >= res[1][0]
    for score, cfg in res:
        assert 0.0 <= score <= 1.0
        assert cfg["device"] == "cpu" and cfg["epochs"] == 2
        assert cfg["log_dir"].startswith(str(tmp_path))
        assert set(cfg) <= {"lr", "beta", "M", "batch_size", "ep_var_mean", "map_est_hypers",
                            "epochs", "device", "log_dir"}
    assert sorted(p.name for p in tmp_path.iterdir()) == ["sweep_toy_0", "sweep_toy_1"]
    # a seed in the spec would override the per-trial seed: refused, as in JAX
    spec = dict(TS.DEFAULT_SPACE, parameters={**TS.DEFAULT_SPACE["parameters"],
                                              "seed": {"values": [3]}})
    with pytest.raises(ValueError, match="per-trial seeds"):
        TS.run_sweep("toy", n_trials=1, spec=spec, device="cpu")


def test_cli_commands_parse(tmp_path, monkeypatch):
    out = tmp_path / "spec.json"
    assert cli.main(["gen_sweep", "--experiment=toy", f"--out={out}"]) == 0
    assert json.loads(out.read_text())["program"] == "python -m vargp_tpu_torch toy"
    seen = {}
    monkeypatch.setattr(TS, "run_sweep", lambda *a, **kw: seen.update(a=a, kw=kw))
    assert cli.main(["run_sweep", "toy", "--n_trials=3", "--epochs=2", "--device=cpu"]) == 0
    assert seen == {"a": ("toy",), "kw": {"n_trials": 3, "epochs": 2, "device": "cpu"}}
    m = np.tril(np.full((3, 3), 0.9))
    ours = tmp_path / "ours.json"
    ours.write_text(json.dumps({"acc_matrix": m.tolist()}))
    cmp = tmp_path / "cmp.json"
    assert cli.main(["compare_methods", str(ours), f"--baselines={{'vcl': '{ours}'}}",
                     f"--out_json={cmp}"]) == 0
    assert set(json.loads(cmp.read_text())) == {"vargp_tpu_torch", "vcl"}
    assert cli.main(["compare_vcl", f"--smnist_json={ours}", f"--pmnist_json={ours}",
                     f"--out_dir={tmp_path / 'vcl'}"]) == 0
    got = json.loads((tmp_path / "vcl" / TA.VCL_JSON).read_text())
    assert got["smnist"]["final"]["VAR-GP (ours, minted)"] == pytest.approx(0.9)
