"""The VAR-GP's other routes through its factorisation, the port against
the JAX package on the CPU:

- ``solve_via_inverse=False``: K_zz factored alone (``gpmath.cholesky``,
  K7's plain version here, ``jnp.linalg.cholesky`` there), the
  materialised posterior folded by triangular solves, the marginal, the
  prefix draws and the KL by solves;
- ``VARGP_TPU_AR_FORM=materialized``: the materialised posterior through
  L^-1 (the task fold, or the block-LDL build from 768 chain rows, here
  forced at small sizes on both sides);
- ``VARGP_TPU_CHOLINV=pallas``: K6's plain version in the forward, the
  default backward.  The JAX package has no K6 route off the TPU unless
  interpreted, so the port's result is held to its own default route
  here (and K6 to the interpreted TPU kernel in test_torch_chol.py).

The "small" (S = 192) and "long" (S = 512: K2's route and the
triangle-skip backward) cases of ``tests/_torch_cases.py``, the JAX
package's own noise replayed, every parameter leaf's gradient of each
ELBO piece.  Tolerances as in test_torch_grad.py and
test_torch_train.py: both sides run f32 on the CPU and differ by
summation order and the factorisations' column order; the ELBO pieces
agree to 1e-5 relative, each gradient leaf to 2e-5 of its largest
magnitude.  Three Yogi steps' parameters agree to 1e-5 absolute: Yogi
normalises each element's step, so on elements of z whose gradient is
near 0 the solves' rounding moves the parameter by up to 7.1e-6 (the
largest seen, solve route; 4.5e-6 materialised), still under 1/900 of
the 9e-3 that three steps at lr 3e-3 can move it.
The K6 route against the default route: the same function by another
factorisation order, the pieces to 1e-5 relative and each leaf to 2e-5.
"""

from dataclasses import replace
from functools import partial

import numpy as np
import jax
import optax
import pytest
import torch

from tests import _torch_cases as C
from vargp_tpu.models import vargp as JV
from vargp_tpu.train import loop as JL
from vargp_tpu_torch.models import vargp as TV
from vargp_tpu_torch.train import loop as TL
from vargp_tpu_torch.train.optim import Yogi, tree_leaves, tree_unflatten
from vargp_tpu_torch.utils import convert

TOL_GRAD = 2e-5
RTOL = 1e-5
LR = 3e-3
ATOL_STEPS = 1e-5
PIECES = ("kl_hypers", "kl_u", "nll")
LEAVES = ("z", "u_mean", "u_tril_vec", "log_mean", "log_logvar")


def _solve(m):
    return dict(m, cfg=replace(m["cfg"], solve_via_inverse=False),
                tcfg=replace(m["tcfg"], solve_via_inverse=False))


def _jax_grads(m, prev, mask, key):
    def pieces(p):
        return JV.loss(p, prev, m["prior"], m["x"], m["y"], key, m["cfg"],
                       weights=m["w"], chain_mask=mask)

    @jax.jit  # a fresh trace: it reads the environment knobs as they are now
    def run(params):
        out, vjp = jax.vjp(pieces, params)
        one_hot = [tuple(jax.numpy.float32(i == j) for j in range(3)) for i in range(3)]
        return out, [vjp(c)[0] for c in one_hot]

    out, grads = run(m["params"])
    return [float(v) for v in out], [[np.asarray(g) for g in jax.tree_util.tree_leaves(gs)]
                                     for gs in grads]


def _port_grads(m, prev, mask, key):
    tp, tprev, tprior, x, y, w, noise, tmask = C.port_inputs(m, prev, mask, key)
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    out = TV.loss(tree_unflatten(tp, leaves), tprev, tprior, x, y, noise, m["tcfg"],
                  weights=w, chain_mask=tmask, device="cpu")
    grads = [[np.zeros(tuple(t.shape), np.float32) if g is None else g.numpy()
              for t, g in zip(leaves, torch.autograd.grad(o, leaves, retain_graph=True,
                                                          allow_unused=True))]
             for o in out]
    return [float(o.detach()) for o in out], grads


def _assert_grads_close(got_out, got, want_out, want, tol=TOL_GRAD):
    for i, name in enumerate(PIECES):
        np.testing.assert_allclose(got_out[i], want_out[i], rtol=RTOL, err_msg=name)
        for leaf, g, j in zip(LEAVES, got[i], want[i]):
            scale = max(float(np.max(np.abs(j))), 1e-30)
            np.testing.assert_allclose(g, j, rtol=0, atol=tol * scale,
                                       err_msg=f"d {name} / d {leaf}")


@pytest.mark.parametrize("size,case", [
    ("small", "chain"), ("small", "padded"), ("small", "task0"), ("long", "chain"),
])
def test_solve_route_loss_and_gradients_match_jax(size, case):
    m = _solve(C.build(size))
    prev, mask = C.chain(m, case)
    key = jax.random.key(3)
    want_out, want = _jax_grads(m, prev, mask, key)
    got_out, got = _port_grads(m, prev, mask, key)
    _assert_grads_close(got_out, got, want_out, want)


@pytest.mark.parametrize("size,fast", [("small", False), ("small", True), ("long", False)])
def test_materialized_form_loss_and_gradients_match_jax(size, fast, monkeypatch):
    """The task fold through L^-1, and (``fast``) the block-LDL build, its
    768-row threshold lowered on both sides."""
    monkeypatch.setenv("VARGP_TPU_AR_FORM", "materialized")
    if fast:
        monkeypatch.setattr(JV, "_FAST_CHAIN_MIN_ROWS", 0)
        monkeypatch.setattr(TV, "_FAST_CHAIN_MIN_ROWS", 0)
    m = C.build(size)
    key = jax.random.key(4)
    want_out, want = _jax_grads(m, m["prev"], None, key)
    got_out, got = _port_grads(m, m["prev"], None, key)
    _assert_grads_close(got_out, got, want_out, want)


@pytest.mark.parametrize("route", ["solve", "materialized"])
@pytest.mark.parametrize("size", ["small", "long"])
def test_three_elbo_steps_match_jax_under_each_route(route, size, monkeypatch):
    """As test_torch_train.py's three Yogi steps, under the route."""
    m = C.build(size)
    if route == "solve":
        m = _solve(m)
    else:
        monkeypatch.setenv("VARGP_TPU_AR_FORM", "materialized")
    beta, n_train = 1.64, 1000
    tx = optax.yogi(LR)
    step = jax.jit(partial(JL.elbo_step, cfg=m["cfg"], tx=tx, beta=beta, n_train=n_train))
    jp, js = m["params"], tx.init(m["params"])
    opt = Yogi(LR)
    keys = [jax.random.key(30 + k) for k in range(3)]
    tp, tprev, tprior, x, y, w, _, _ = C.port_inputs(m, m["prev"], None, keys[0])
    ts = opt.init(tp)
    for key in keys:
        jp, js, jloss, jaux = step(jp, js, m["prev"], m["prior"], m["x"], m["y"], m["w"], key)
        *_, noise, _ = C.port_inputs(m, m["prev"], None, key)
        tp, ts, tloss, taux = TL.elbo_step(tp, ts, tprev, tprior, x, y, w, noise, cfg=m["tcfg"],
                                           opt=opt, beta=beta, n_train=n_train, device="cpu")
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
        for name, a, b in zip(PIECES, taux, jaux):
            np.testing.assert_allclose(float(a), float(b), rtol=RTOL, err_msg=name)
    got = jax.tree_util.tree_leaves(convert.params_to_numpy(tp))
    for g, j in zip(got, jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(j), rtol=0, atol=ATOL_STEPS)


@pytest.mark.parametrize("route", ["solve", "materialized"])
def test_predict_matches_jax_under_each_route(route, monkeypatch):
    m = C.build("small")
    if route == "solve":
        m = _solve(m)
    else:
        monkeypatch.setenv("VARGP_TPU_AR_FORM", "materialized")
    prev, mask = C.chain(m, "padded")
    key = jax.random.key(5)
    want = jax.jit(partial(JV.predict, cfg=m["cfg"]))(m["params"], prev, m["x"], key,
                                                     chain_mask=mask)
    tp, tprev, _, x, _, _, _, tmask = C.port_inputs(m, prev, mask, key)
    hyper, _, lik = C.jax_draws(m, key, 0)  # predict splits its key as loss does
    got = TV.predict(tp, tprev, x, convert.noise_for_predict(hyper, lik, device="cpu"), m["tcfg"],
                     chain_mask=tmask, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("size", ["small", "long"])
def test_solve_route_factors_once_through_k7(size, monkeypatch):
    """Under solve_via_inverse=False a step factors K_zz in one call of
    K7's wrapper and reaches neither K6 nor the blocked route."""
    import vargp_tpu_torch.ops.dispatch as D

    m = _solve(C.build(size))
    tp, tprev, tprior, x, y, w, noise, _ = C.port_inputs(m, m["prev"], None, jax.random.key(6))
    calls = []
    orig = D._chol_kernel
    monkeypatch.setattr(D, "_chol_kernel", lambda K: calls.append(tuple(K.shape)) or orig(K))
    monkeypatch.setattr(D, "_chol_and_inv_fwd", None)
    TL.elbo_step(tp, Yogi(LR).init(tp), tprev, tprior, x, y, w, noise, cfg=m["tcfg"],
                 opt=Yogi(LR), beta=1.0, n_train=100, device="cpu")
    S = (len(m["prev"]) + 1) * m["dims"]["M"]
    assert calls == [(m["dims"]["H"], m["dims"]["O"], S, S)]


@pytest.mark.parametrize("size,case", [("small", "chain"), ("small", "padded"),
                                       ("small", "task0"), ("long", "chain")])
def test_fused_route_matches_the_default_route(size, case, monkeypatch):
    """VARGP_TPU_CHOLINV=pallas: K6's plain version replaces the blocked
    forward; the backward is the same rule on (L, L^-1)."""
    import vargp_tpu_torch.ops.dispatch as D

    m = C.build(size)
    prev, mask = C.chain(m, case)
    key = jax.random.key(7)
    want_out, want = _port_grads(m, prev, mask, key)
    calls = []
    orig = D._chol_inv_kernel
    monkeypatch.setattr(D, "_chol_inv_kernel", lambda K: calls.append(tuple(K.shape)) or orig(K))
    monkeypatch.setenv("VARGP_TPU_CHOLINV", "pallas")
    got_out, got = _port_grads(m, prev, mask, key)
    assert len(calls) == 1
    _assert_grads_close(got_out, got, want_out, want)


@pytest.mark.parametrize("knob", ["VARGP_TPU_CHOLINV", "VARGP_TPU_AR_FORM"])
def test_unknown_knob_values_raise(knob, monkeypatch):
    m = C.build("small")
    tp, tprev, tprior, x, y, w, noise, _ = C.port_inputs(m, m["prev"], None, jax.random.key(1))
    monkeypatch.setenv(knob, "Pallas" if knob == "VARGP_TPU_CHOLINV" else "materialised")
    with pytest.raises(ValueError, match=knob):
        TV.loss(tp, tprev, tprior, x, y, noise, m["tcfg"], weights=w, device="cpu")
