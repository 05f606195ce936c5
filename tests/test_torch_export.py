"""Predictor export (``utils/export.py``) on the CPU: ``predict`` of the
shared small case (3 classes, M = 64, D = 16, B = 32; a 2-task chain, S =
192, factored in 2 blocks of 96) exported with ``torch.export``, saved,
loaded back and called on the same noise.

- The loaded program's probabilities equal eager ``predict``'s bit for
  bit: the graph runs the same operators on the same inputs, called twice
  with the same noise, and so does eager ``predict`` reusing its
  posterior; the trace keeps no posterior.
- They match the JAX package's ``predict`` on the JAX draws replayed, to
  the parity suite's limits: 1e-6 absolute on the plain model
  (``tests/test_torch_vargp.py``), 1e-5 under the deep kernel
  (``tests/test_torch_dkl.py``).
- The graph holds one ``vargp_torch::`` node per kernel launch of the
  route chosen at export time, the JAX-free path of a loaded call: K1, K3
  on each diagonal block and K4; K6 in K3's place under
  ``VARGP_TPU_CHOLINV=pallas``; K5's two modes under the deep kernel.
"""

import numpy as np
import jax
import pytest
import torch

from tests._torch_cases import build, build_dkl, jax_draws, np_tree
from vargp_tpu.models import vargp as JV
from vargp_tpu_torch.models import vargp as TV
from vargp_tpu_torch.utils import convert
from vargp_tpu_torch.utils import export as E
from vargp_tpu_torch.utils import tracing

ATOL = {False: 1e-6, True: 1e-5}  # plain, deep kernel
NODES = {
    ("plain", "xla"): {"sym_gram": 1, "diag_chol": 2, "cross_gram": 1},
    ("plain", "pallas"): {"sym_gram": 1, "chol_inv": 1, "cross_gram": 1},
    ("dkl", "xla"): {"rbf_gram_sym": 1, "diag_chol": 2, "rbf_gram": 1},
}


def _graph_ops(program) -> dict:
    out = {}
    for n in program.graph.nodes:
        name = str(n.target)
        if n.op == "call_function" and name.startswith("vargp_torch."):
            key = name.split(".")[1]
            out[key] = out.get(key, 0) + 1
    return out


@pytest.mark.parametrize("model,route", list(NODES))
def test_exported_predictor_round_trip(tmp_path, monkeypatch, model, route):
    dkl = model == "dkl"
    m = build_dkl("small") if dkl else build("small")
    d = m["dims"]
    key = jax.random.key(4)
    want = JV.predict(m["params"], m["prev"], m["x"], key, m["cfg"])  # the JAX default route
    monkeypatch.setenv("VARGP_TPU_CHOLINV", route)
    hyper, _, lik = jax_draws(m, key, 0)
    noise = convert.noise_for_predict(hyper, lik, device="cpu")
    tp, tprev, _ = convert.params_from_numpy(np_tree(m["params"]), np_tree(m["prev"]),
                                             device="cpu")
    x = torch.tensor(np.asarray(m["x"]))
    TV.clear_posterior_cache()
    path = E.export_predictor(tp, tprev, m["tcfg"], d["B"], str(tmp_path / "p.pt2"),
                              n_f=d["N_F"], n_var_samples=d["H"], device="cpu")
    assert TV._entry is None  # the trace neither kept nor reused a posterior
    monkeypatch.delenv("VARGP_TPU_CHOLINV")  # the saved program keeps its route
    pred = E.load_predictor(path, device="cpu")
    assert _graph_ops(pred.program) == NODES[(model, route)]
    assert pred.meta["noise_shapes"] == {k: list(v.shape) for k, v in noise.items()}
    got = pred(x, noise)
    assert torch.equal(pred(x, noise), got)  # called twice with the same noise
    monkeypatch.setenv("VARGP_TPU_CHOLINV", route)
    reuses = tracing.POSTERIOR["reuse"]
    with torch.no_grad():
        eager = TV.predict(tp, tprev, x, noise, m["tcfg"], device="cpu")
        again = TV.predict(tp, tprev, x, noise, m["tcfg"], device="cpu")
    assert tracing.POSTERIOR["reuse"] == reuses + 1  # the second call reused the first's
    assert torch.equal(got, eager)
    assert torch.equal(again, eager)
    assert got.shape == (d["B"], d["O"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL[dkl])


def test_load_predictor_refuses_another_device(tmp_path, monkeypatch):
    """A program runs on the device it was exported on: without a card the
    default (the card) raises, and a device other than the export's is
    refused."""
    m = build("small")
    tp, tprev, _ = convert.params_from_numpy(np_tree(m["params"]), np_tree(m["prev"]),
                                             device="cpu")
    path = E.export_predictor(tp, tprev, m["tcfg"], 8, str(tmp_path / "p.pt2"), n_f=2,
                              n_var_samples=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            E.load_predictor(path)
    monkeypatch.setattr(E, "resolve_device", lambda device: torch.device("cuda"))
    with pytest.raises(ValueError, match="exported for cpu"):
        E.load_predictor(path)


def test_noise_shapes_follow_the_budget():
    cfg = TV.VARGPConfig(M=4, out_size=3, in_size=5, n_f=7, n_var_samples=2)
    assert E.noise_shapes(cfg, 9) == {"hyper_eps": (2, 6), "lik_eps": (2, 7, 3, 9)}
    cfg = TV.VARGPConfig(M=4, out_size=3, in_size=5, n_f=7, n_var_samples=2, map_est_hypers=True)
    assert E.noise_shapes(cfg, 9)["lik_eps"] == (1, 7, 3, 9)
