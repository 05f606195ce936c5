"""The method comparisons and the figures of the port's experiments
against the JAX package's (``vargp_tpu/experiments/analysis.py``,
``plots.py``):

- ``compare_methods`` on ``tests/test_analysis.py``'s inputs gives the JAX
  numbers (ours under ``vargp_tpu_torch``);
- ``compare_vcl`` on the minted ``results/smnist_r4`` and
  ``results/pmnist_r4`` analyses, written to a temporary directory,
  reproduces the minted ``results/compare/vcl_overlay.json`` curves and
  finals to 1e-12, and nothing is written under ``results/``;
- each plot function, and each analysis's figure (``matrices_torch.png``,
  ``inducing_torch.png``, ``toy_density_torch.png``; ``varying_M.png``),
  writes a non-empty PNG, the analyses on tiny random chains saved to a
  temporary directory;
- without matplotlib (the card's machine) a figure is skipped with one
  printed line and the JSON is still written.
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest

from vargp_tpu.experiments import analysis as JA
from vargp_tpu_torch.experiments import analysis as TA
from vargp_tpu_torch.experiments import plots
from vargp_tpu_torch.experiments import vargp_run as R
from vargp_tpu_torch.models import global_svgp as G
from vargp_tpu_torch.models import vargp as V
from vargp_tpu_torch.utils.checkpoint import save_chain

REPO = Path(__file__).resolve().parents[1]
RESULTS = REPO / "results"


def _matrices(tmp_path):
    rng = np.random.default_rng(0)
    ours = np.tril(0.95 + 0.05 * rng.random((4, 4)))
    vcl = np.tril(0.80 + 0.05 * rng.random((4, 4)))
    csv_path = tmp_path / "vcl.csv"
    np.savetxt(csv_path, vcl, delimiter=",")
    json_path = tmp_path / "ours.json"
    json_path.write_text(json.dumps({"acc_matrix": ours.tolist()}))
    np.save(tmp_path / "vcl.npy", vcl)
    return str(json_path), {"vcl": str(csv_path), "vcl_npy": str(tmp_path / "vcl.npy"),
                            "vcl_coreset": vcl}


def test_compare_methods_matches_jax(tmp_path):
    ours, baselines = _matrices(tmp_path)
    want = JA.compare_methods(ours, baselines)
    got = TA.compare_methods(ours, baselines, out_json=str(tmp_path / "cmp.json"),
                             out_png=str(tmp_path / "cmp.png"))
    assert set(got) == {"vargp_tpu_torch", "vcl", "vcl_npy", "vcl_coreset"}
    want["vargp_tpu_torch"] = want.pop("vargp_tpu")
    assert got == want
    assert json.loads((tmp_path / "cmp.json").read_text()) == json.loads(json.dumps(got))
    assert os.path.getsize(tmp_path / "cmp.png") > 0
    with pytest.raises(ValueError, match="square"):
        TA.compare_methods(np.zeros((2, 3)), {})


def _results_listing():
    return sorted((str(p.relative_to(RESULTS)), p.stat().st_mtime_ns)
                  for p in RESULTS.rglob("*") if p.is_file())


def test_compare_vcl_reproduces_the_minted_overlay(tmp_path, monkeypatch):
    """From the repository's root, as ``python -m vargp_tpu_torch compare_vcl
    --out_dir=<tmp>`` runs it: the default inputs are the minted analyses."""
    monkeypatch.chdir(REPO)
    before = _results_listing()
    out = TA.compare_vcl(out_dir=str(tmp_path))
    assert _results_listing() == before
    minted = json.loads((RESULTS / "compare" / "vcl_overlay.json").read_text())
    written = json.loads((tmp_path / "vcl_overlay_torch.json").read_text())
    for got in (out, written):
        assert got["provenance_vcl"] == minted["provenance_vcl"]
        for name in ("smnist", "pmnist"):
            assert got[name]["ours_source"] == minted[name]["ours_source"]
            assert set(got[name]["curves"]) == set(minted[name]["curves"])
            for k, v in minted[name]["curves"].items():
                np.testing.assert_allclose(got[name]["curves"][k], v, rtol=0, atol=1e-12)
                np.testing.assert_allclose(got[name]["final"][k], minted[name]["final"][k],
                                           rtol=0, atol=1e-12)
    for name in ("smnist", "pmnist"):
        if importlib.util.find_spec("matplotlib") is not None:
            assert os.path.getsize(tmp_path / f"vcl_overlay_{name}_torch.png") > 0
    assert not (tmp_path / "vcl_overlay.json").exists()


def test_figures_skip_without_matplotlib(tmp_path, monkeypatch, capsys):
    """The card's machine has no matplotlib: each figure is skipped with a
    printed line; the comparison's JSON is written all the same."""
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else real(name, *a))
    ours, baselines = _matrices(tmp_path)
    TA.compare_methods(ours, baselines, out_json=str(tmp_path / "cmp.json"),
                       out_png=str(tmp_path / "cmp.png"))
    assert os.path.getsize(tmp_path / "cmp.json") > 0 and not (tmp_path / "cmp.png").exists()
    assert "cmp.png skipped: matplotlib is not installed" in capsys.readouterr().out


def test_each_plot_function_writes_a_png(tmp_path):
    pytest.importorskip("matplotlib")
    from vargp_tpu_torch import data

    rng = np.random.default_rng(1)
    xs = np.linspace(-3, 3, 12, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs)
    paths = [
        plots.plot_toy_densities(gx, gy, rng.random((2, 12, 12, 4)),
                                 dataset=data.make_toy_dataset(seed=0),
                                 out_path=str(tmp_path / "toy.png")),
        plots.plot_matrices(np.tril(rng.random((3, 3))), rng.random((3, 3)),
                            out_path=str(tmp_path / "m.png")),
        plots.plot_inducing_images(rng.random((3, 5, 784)), out_path=str(tmp_path / "z.png")),
        plots.plot_accuracy_vs_m({20: 0.9, 40: 0.95}, out_path=str(tmp_path / "vm.png")),
        plots.plot_method_comparison({"a": [0.9, 0.8], "b": [0.95, 0.9]},
                                     out_path=str(tmp_path / "cmp.png")),
    ]
    for p in paths:
        assert os.path.getsize(p) > 0
    with pytest.raises(ValueError, match="images"):
        plots.plot_inducing_images(rng.random((3, 5, 10)), out_path=str(tmp_path / "bad.png"))


def _random_tree(template, rng):
    """A parameter tree of the template's shapes: small random values,
    near-identity scale factors, lengthscales near the data's."""
    def fill(path, a):
        if "u_tril_vec" in path:
            M = int((np.sqrt(8 * a.shape[-1] + 1) - 1) / 2)
            return (np.eye(M)[np.tril_indices(M)] + 0.05 * rng.standard_normal(a.shape)).astype(
                np.float32)
        if "log_mean" in path:
            return np.full(a.shape, np.log(max(1.0, np.sqrt(a.shape[0]) / 4)), np.float32)
        if "log_logvar" in path:
            return np.full(a.shape, -3.0, np.float32)
        return (0.3 * rng.standard_normal(a.shape)).astype(np.float32)

    return type(template)(*(
        type(v)(*(fill(f"{k}.{kk}", vv) for kk, vv in zip(v._fields, v)))
        if hasattr(v, "_fields") else (None if v is None else fill(k, v))
        for k, v in zip(template._fields, template)))


def _save_chain(log_dir, templates):
    rng = np.random.default_rng(2)
    for t, tmpl in enumerate(templates):
        save_chain(str(log_dir), t, _random_tree(tmpl, rng))


@pytest.mark.parametrize("analysis", ["smnist", "pmnist", "sdigits", "toy", "toy_global",
                                      "smnist_global"])
def test_each_analysis_writes_its_figures(tmp_path, analysis):
    pytest.importorskip("matplotlib")
    kw = dict(n_f=2, n_var_samples=2, device="cpu")
    if analysis in ("smnist", "pmnist", "sdigits"):
        D = 64 if analysis == "sdigits" else 784
        _save_chain(tmp_path, [TA.params_template(V.VARGPConfig(M=3, out_size=10, in_size=D))] * 2)
        if analysis == "sdigits":
            pytest.importorskip("sklearn")
        fn = getattr(TA, f"analyze_{analysis}")
        fn(str(tmp_path), n_tasks=2, M=3, **kw)
        want = [TA.MATRICES_PNG, TA.INDUCING_PNG]
    elif analysis == "smnist_global":
        _save_chain(tmp_path, [TA.global_params_template(
            G.GlobalSVGPConfig(M=3, out_size=10, in_size=784))] * 2)
        TA.analyze_smnist_global(str(tmp_path), n_tasks=2, M=3, **kw)
        want = [TA.MATRICES_PNG]
    elif analysis == "toy":
        _save_chain(tmp_path, [TA.params_template(V.VARGPConfig(M=4, out_size=4, in_size=2))] * 2)
        TA.analyze_toy(str(tmp_path), n_tasks=2, M=4, n=8, **kw)
        want = [TA.TOY_DENSITY_PNG]
    else:
        _save_chain(tmp_path, [TA.global_params_template(
            G.GlobalSVGPConfig(M=4 * (t + 1), out_size=4, in_size=2)) for t in range(2)])
        TA.analyze_toy_global(str(tmp_path), n_tasks=2, M=4, n=8, **kw)
        want = [TA.TOY_DENSITY_PNG]
    for name in want:
        assert os.path.getsize(tmp_path / name) > 0, name
    assert not any((tmp_path / n).exists() for n in ("matrices.png", "inducing.png",
                                                     "toy_density.png"))


def test_varying_m_writes_its_figure(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    monkeypatch.setattr(R, "split_digits",
                        lambda **kw: ([], [{"task1/test/acc": 0.5 + kw["M"] / 100}]))
    R.varying_m(ms=(4, 8), dataset="s_digits", n_tasks=2, log_dir=str(tmp_path))
    assert os.path.getsize(tmp_path / "varying_M.png") > 0
    assert json.loads((tmp_path / "varying_M.json").read_text()) == {"4": 0.54, "8": 0.58}


def test_figures_go_beside_the_json_not_the_chain(tmp_path):
    """An analysis of a chain into another directory (``out_json``, as the
    minted chains are analysed) writes its figures there, nothing beside
    the chain."""
    pytest.importorskip("matplotlib")
    chain_dir, out_dir = tmp_path / "chain", tmp_path / "out"
    chain_dir.mkdir()
    out_dir.mkdir()
    _save_chain(chain_dir, [TA.params_template(V.VARGPConfig(M=3, out_size=10, in_size=784))] * 2)
    before = sorted(os.listdir(chain_dir))
    TA.analyze_smnist(str(chain_dir), n_tasks=2, M=3, n_f=2, n_var_samples=2, device="cpu",
                      out_json=str(out_dir / "a.json"))
    assert sorted(os.listdir(chain_dir)) == before
    assert sorted(os.listdir(out_dir)) == ["a.json", TA.INDUCING_PNG, TA.MATRICES_PNG]
