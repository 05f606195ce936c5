"""The port's global continual SVGP (``models/global_svgp.py``,
``train/loop_global.py``) against the JAX package's on the CPU.

Cases (``tests/_torch_cases.py::build_global``): 3 classes, D = 5,
B = 16, 2 hyper samples, 4 function samples; task 0 (M = 6), a grown
task (a previous task of 6 rows, M = 9) and the first step of a task
that grows nothing (z a copy of prev.z, where the predictive covariance
Kxx - W^T W + C^T C is rounding around 0 before the jitter).  Both sides
get the same parameters and the JAX package's own draws.

Tolerances: the four ELBO pieces agree to 1e-5 relative, each leaf's
gradient of each piece to 2e-5 of that leaf's largest magnitude,
probabilities to 1e-6 absolute.  The comparisons run in float64 (the JAX
side under ``jax.enable_x64``, on its float64 draws), where both sides
compute the same function with rounding far below those limits, and in
f32 on the f32 draws.  In f32 the JAX package's own rounding reaches the
limits: on the grown case its d kl_u / d z lies 1.8e-5 of the leaf's
scale from the exact gradient (the port's 1.1e-5), and on the minted
S-MNIST chain its probabilities 1.8e-5 from the exact ones (the port's
1.5e-5).  So an f32 gradient or probability of the port is held to the
exact value on the same draws (the port in float64, which the float64
comparisons hold to the JAX package), within the limit or within twice
the JAX package's own f32 distance from it, whichever is larger.
The training loop (``train_task``, the evaluation, the ELBO step) is
held to the JAX package's in ``tests/test_torch_global_loop.py``.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests import _torch_cases as C
from vargp_tpu import data as jdata
from vargp_tpu.models import global_svgp as JG
from vargp_tpu.train import loop as JL
from vargp_tpu_torch import data as tdata
from vargp_tpu_torch.experiments import analysis as TA
from vargp_tpu_torch.models import global_svgp as TG
from vargp_tpu_torch.train import loop as TL
from vargp_tpu_torch.train import loop_global as TLG
from vargp_tpu_torch.train.optim import tree_leaves, tree_unflatten
from vargp_tpu_torch.utils import convert
from vargp_tpu_torch.utils.checkpoint import _treedef, load_pytree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
TOL_GRAD = 2e-5
ATOL_PROBS = 1e-6
PIECES = ("kl_hypers", "kl_u", "u_prev_reg", "nll")
LEAVES = ("z", "u_mean", "u_tril_vec", "log_mean", "log_logvar")

_jit_predict = jax.jit(JG.predict, static_argnames=("cfg", "n_f", "n_var_samples"))


_port = C.global_port
_port_noise = C.global_noise


def _jax_pieces_and_grads(m, key, f64=False):
    """The JAX loss's four pieces and each piece's gradient (one list of
    leaves per piece), in f32 or, under ``jax.enable_x64``, in float64 on
    float64 draws."""
    with jax.enable_x64(f64):
        cast = C.to_f64 if f64 else (lambda t: t)
        params, prev, prior, x, w = (cast(m[k]) for k in ("params", "prev", "prior", "x", "w"))

        def pieces(p):
            return JG.loss(p, prev, prior, x, m["y"], key, m["cfg"], weights=w)

        def run(params):
            out, vjp = jax.vjp(pieces, params)
            one_hot = [tuple(jnp.asarray(float(i == j), out[0].dtype) for j in range(4))
                       for i in range(4)]
            return out, [vjp(c)[0] for c in one_hot]

        out, grads = jax.jit(run)(params)
        return [float(v) for v in out], [[np.asarray(g) for g in jax.tree_util.tree_leaves(gs)]
                                         for gs in grads]


def _limit(tol, scale, exact, want32):
    """The f32 limit against the exact value: ``tol`` of ``scale``, or twice
    the JAX package's own f32 distance from it."""
    return max(tol * scale, 2.0 * float(np.max(np.abs(np.asarray(want32) - exact))))


def _port_pieces_and_grads(m, noise, dtype):
    tp, tprev, tprior, x, y, w = _port(m, dtype)
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    out = TG.loss(tree_unflatten(tp, leaves), tprev, tprior, x, y,
                  {k: v.to(dtype) for k, v in noise.items()}, m["tcfg"], weights=w, device="cpu")
    grads = []
    for piece in out:
        got = (torch.autograd.grad(piece, leaves, retain_graph=True, allow_unused=True)
               if piece.requires_grad else [None] * len(leaves))
        grads.append([np.zeros(tuple(t.shape)) if g is None else g.double().numpy()
                      for t, g in zip(leaves, got)])
    return [float(v.detach()) for v in out], grads


@pytest.mark.parametrize("precision", ["float64", "f32"])
@pytest.mark.parametrize("case", ["task0", "grown", "copy"])
def test_loss_pieces_and_gradients_match_jax(case, precision):
    """Each ELBO piece and each leaf's gradient of it, task 0 and with a
    previous task (grown, and at z == prev.z).  float64: both packages in
    float64 on the JAX key's float64 draws.  f32: the pieces against the
    JAX package's f32 pieces; the gradients against the exact gradient on
    the same f32 draws (the port in float64, which the float64 case holds
    to the JAX package), within 2e-5 of the leaf's scale or twice the JAX
    package's own f32 distance from it."""
    m = C.build_global(case)
    key = jax.random.key(3)
    f64 = precision == "float64"
    want_out, want = _jax_pieces_and_grads(m, key, f64=f64)
    noise = _port_noise(m, key, torch.float64 if f64 else torch.float32)
    out, got = _port_pieces_and_grads(m, noise, torch.float64 if f64 else torch.float32)
    if not f64:
        exact_out, exact = _port_pieces_and_grads(m, noise, torch.float64)
    if case == "task0":
        assert out[2] == want_out[2] == 0.0
    else:
        assert abs(want_out[2]) > 1e-3  # the regulariser is live
    for i, name in enumerate(PIECES):
        np.testing.assert_allclose(out[i], want_out[i], rtol=RTOL, err_msg=name)
        if case == "task0" and name == "u_prev_reg":
            continue
        ref = want[i] if f64 else exact[i]
        for k, (leaf, g, r) in enumerate(zip(LEAVES, got[i], ref)):
            scale = max(float(np.max(np.abs(r))), 1e-30)
            atol = TOL_GRAD * scale if f64 else _limit(TOL_GRAD, scale, r, want[i][k])
            np.testing.assert_allclose(g, r, rtol=0, atol=atol, err_msg=f"d {name} / d {leaf}")


def test_regulariser_draws_keep_their_gradient():
    """u_prev_reg is differentiable through its samples: its gradient with
    respect to reg_eps is non-zero (no detach on the samples' path), and
    the gradient with respect to z carries the samples' term."""
    m = C.build_global("grown")
    tp, tprev, tprior, x, y, w = _port(m)
    noise = _port_noise(m, jax.random.key(3))
    noise["reg_eps"].requires_grad_()
    out = TG.loss(tp, tprev, tprior, x, y, noise, m["tcfg"], weights=w, device="cpu")
    (g,) = torch.autograd.grad(out[2], [noise["reg_eps"]])
    assert float(g.abs().max()) > 1e-3


@pytest.mark.parametrize("case", ["task0", "grown"])
def test_predict_matches_jax(case):
    """``predict`` at the evaluation budgets (n_f = 5, H = 3) on its own
    draws of the JAX key; prev is not read."""
    m = C.build_global(case)
    key = jax.random.key(5)
    want = _jit_predict(m["params"], m["prev"], m["x"], key, cfg=m["cfg"], n_f=5, n_var_samples=3)
    cfg_eval = JL.V.eval_budget_cfg(m["cfg"], n_f=5, n_var_samples=3)
    hyper, lik = C.global_predict_draws(key, cfg_eval, m["x"].shape[0])
    tp, tprev, _, x, _, _ = _port(m)
    got = TG.predict(tp, tprev, x, convert.noise_for_global_loss(hyper, lik, device="cpu"),
                     m["tcfg"], n_f=5, n_var_samples=3, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL_PROBS)
    with pytest.raises(ValueError, match="expected shape"):  # noise of other budgets
        TG.predict(tp, tprev, x, convert.noise_for_global_loss(hyper, lik, device="cpu"),
                   m["tcfg"], device="cpu")


@pytest.mark.parametrize("prior_from", [False, True])
def test_init_params_matches_jax(prior_from):
    """The same parameters and prior from the draws of the JAX key."""
    jcfg, tcfg = C.global_cfgs(6)
    key = jax.random.key(9)
    z = jnp.asarray(np.random.default_rng(0).standard_normal((3, 6, 5)).astype(np.float32))
    kern = C.build_global("task0")["params"].kernel if prior_from else None
    want_p, want_prior = JG.init_params(key, z, jcfg, kernel_prior_from=kern)
    k_kern, k_u = jax.random.split(key)
    t = lambda a: torch.tensor(np.asarray(a))
    tkern = None if kern is None else convert.params_from_numpy(
        C.np_tree(C.build_global("task0")["params"]), device="cpu")[0].kernel
    got_p, got_prior = TG.init_params(t(jax.random.normal(k_kern, (6,))),
                                      t(jax.random.normal(k_u, (3, 6, 1))), t(z), tcfg,
                                      kernel_prior_from=tkern)
    assert type(got_p).__name__ == type(want_p).__name__ == "GlobalSVGPParams"
    for g, w in zip(tree_leaves(got_p) + list(got_prior),
                    jax.tree_util.tree_leaves(want_p) + list(want_prior)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_grow_inducing_both_branches():
    """Nothing to add (M_new <= M_prev): a fresh copy of prev_z, as the JAX
    function returns.  Rows to add: prev_z's rows, then per class the
    rows ``select_inducing`` draws from the same generator state."""
    rng = np.random.default_rng(1)
    prev_z = torch.tensor(rng.standard_normal((3, 6, 5)).astype(np.float32))
    data = torch.tensor(rng.standard_normal((40, 5)).astype(np.float32))
    for M_new in (6, 4):
        got = TG.grow_inducing(torch.Generator().manual_seed(0), prev_z, data, M_new, 3)
        want = JG.grow_inducing(jax.random.key(0), jnp.asarray(prev_z.numpy()),
                                jnp.asarray(data.numpy()), M_new, 3)
        assert torch.equal(got, prev_z) and np.array_equal(got.numpy(), np.asarray(want))
        assert got.data_ptr() != prev_z.data_ptr()
    got = TG.grow_inducing(torch.Generator().manual_seed(0), prev_z, data, 9, 3)
    want = JG.grow_inducing(jax.random.key(0), jnp.asarray(prev_z.numpy()),
                            jnp.asarray(data.numpy()), 9, 3)
    assert tuple(got.shape) == np.asarray(want).shape == (3, 9, 5)
    assert torch.equal(got[:, :6], prev_z)
    added = TL.V.select_inducing(torch.Generator().manual_seed(0), data, 3, 3)
    assert torch.equal(got[:, 6:], added)
    for o in range(3):  # distinct data rows, as the JAX permutation draws them
        assert len({tuple(r) for r in got[o, 6:].tolist()}) == 3


def test_freeze_task_matches_jax():
    m = C.build_global("grown")
    want = JG.freeze_task(m["params"])
    tp = _port(m)[0]
    got = TG.freeze_task(tp)
    assert isinstance(got, TG.GlobalPrev)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
        assert not g.requires_grad
    assert got.z.data_ptr() != tp.z.data_ptr()


def _toy_task0():
    return tdata.filter_by_class(tdata.make_toy_dataset(seed=0), [0, 1])


@pytest.mark.parametrize("call", ["train_task", "loss", "predict"])
def test_entry_points_need_a_card_unless_asked(call):
    """With no card, device=None raises before any work; device='cpu' runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None would run on it")
    m = C.build_global("grown")
    tp, tprev, tprior, x, y, w = _port(m)
    noise = _port_noise(m, jax.random.key(3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if call == "train_task":
            tr = _toy_task0()
            TLG.train_task(0, 0, tr, tr, tr, m["tcfg"], TL.TrainHyperparams())
        elif call == "loss":
            TG.loss(tp, tprev, tprior, x, y, noise, m["tcfg"], weights=w)
        else:
            TG.predict(tp, tprev, x, {k: noise[k] for k in ("hyper_eps", "lik_eps")}, m["tcfg"])


# ---------------------------------------------------------------------------
# The minted S-MNIST global chain
# ---------------------------------------------------------------------------


def test_minted_smnist_global_ckpt4_predicts_as_jax():
    """``results/smnist_global/ckpt4.npz`` read through the port's template
    (whose structure string is the one the JAX package wrote beside it),
    then one 512-row batch of the surrogate's test split at the model's
    budgets (H = 3, n_f = 10) on the JAX key's draws: probabilities within
    1e-6 of the JAX package's in float64, and in f32 within twice the JAX
    package's own f32 distance from its float64 result."""
    path = os.path.join(REPO, "results", "smnist_global", "ckpt4.npz")
    tcfg = TG.GlobalSVGPConfig(M=60, out_size=10, in_size=784)
    template = TA.global_params_template(tcfg)
    with open(path + ".structure.json") as f:
        assert json.load(f)["treedef"] == _treedef(template)
    tree = load_pytree(path, template)
    jcfg = JG.GlobalSVGPConfig(M=60, out_size=10, in_size=784)
    jparams = jax.tree_util.tree_map(jnp.asarray, JG.GlobalSVGPParams(
        tree.z, tree.u_mean, tree.u_tril_vec, JG.RBFParams(*tree.kernel)))
    x = next(jdata.eval_batches(jdata.filter_by_class(jdata.load_mnist(None, train=False),
                                                      [8, 9]), 512)).x
    key = jax.random.key(2)
    tp = convert.params_from_numpy(tree, device="cpu")[0]
    assert isinstance(tp, TG.GlobalSVGPParams)

    def port(dtype, hyper, lik):
        p = tree_unflatten(tp, [a.to(dtype) for a in tree_leaves(tp)])
        noise = {"hyper_eps": hyper.to(dtype), "lik_eps": lik.to(dtype)}
        return TG.predict(p, None, torch.tensor(x).to(dtype), noise, tcfg,
                          device="cpu").double().numpy()

    want = {}
    for f64 in (True, False):
        with jax.enable_x64(f64):
            jdt = jnp.float64 if f64 else jnp.float32
            jp = C.to_f64(jparams) if f64 else jparams
            want[f64] = (np.asarray(_jit_predict(jp, None, jnp.asarray(x, jdt), key, cfg=jcfg),
                                    np.float64),
                         [torch.tensor(np.asarray(a))
                          for a in C.global_predict_draws(key, jcfg, 512, jdt)])
    want64, draws64 = want[True]
    np.testing.assert_allclose(port(torch.float64, *draws64), want64, rtol=0, atol=ATOL_PROBS)
    want32, draws32 = want[False]
    exact = port(torch.float64, *draws32)
    got32 = port(torch.float32, *draws32)
    np.testing.assert_allclose(got32, exact, rtol=0, atol=_limit(ATOL_PROBS, 1.0, exact, want32))
    assert float(got32.max()) > 0.5  # a trained model, not a flat prediction
