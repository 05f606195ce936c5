"""The plain versions of K1 and K2 (sym-Gram), K4 (cross-Gram) and K5
(generic Gram on pre-scaled inputs), the Grams' backward rules, and the
kernel, likelihood and hyper-sample functions around them, against the
JAX package on the CPU; the Grams also against the Pallas kernels run in
interpret mode.

Tolerances: Gram values lie in (0, gamma2] and both sides compute the
squared distance in f32 through the norm expansion, so they differ by
summation order only (1e-6 relative).  The Pallas cross-Gram in its
production precision emulates a bf16x3 product, which moves the squared
distance by about 1e-5 relative: its bound is 1e-4.  The backward rules
are the same products on the same f32 inputs in another association:
each cotangent is held to 1e-5 of its largest magnitude.  K5 and its
rule are held to 1e-5 relative, as the other Grams.
"""

import functools
import unittest.mock as mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from vargp_tpu.kernels import rbf as jrbf
from vargp_tpu.likelihoods import softmax as jsoft
from vargp_tpu_torch.kernels import rbf as trbf
from vargp_tpu_torch.likelihoods import softmax as tsoft
from vargp_tpu_torch.ops import dispatch as tdispatch
from vargp_tpu_torch.ops.cuda.cross_gram import cross_gram, cross_gram_plain
from vargp_tpu_torch.ops.cuda.rbf_gram import rbf_gram, rbf_gram_plain
from vargp_tpu_torch.ops.cuda.sym_gram import sym_gram, sym_gram_plain
from vargp_tpu_torch.ops.cuda.sym_gram_tri import sym_gram_tri

f32 = np.float32


def _t(a):
    return torch.tensor(np.asarray(a))


def _gram_inputs(seed, O, M, D, H, B=1):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((O, M, D)) / np.sqrt(D)).astype(f32)
    x = (rng.standard_normal((B, D)) / np.sqrt(D)).astype(f32)
    theta = (rng.standard_normal((H, D + 1)) * 0.2).astype(f32)
    return z, x, theta


@pytest.mark.parametrize("O,M,D,H", [(1, 1, 1, 1), (2, 9, 7, 3), (3, 70, 33, 2)])
def test_sym_gram_matches_jax(O, M, D, H):
    z, _, theta = _gram_inputs(M, O, M, D, H)
    got = trbf.sym_gram(_t(theta), _t(z)).numpy()
    want = np.asarray(jrbf.sym_gram(jnp.asarray(theta), jnp.asarray(z)))
    assert got.shape == (H, O, M, M)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # and the generic (pre-scaled) Gram the fused one replaces
    np.testing.assert_allclose(got, np.asarray(jrbf.gram(jnp.asarray(theta), jnp.asarray(z))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("O,M,B,D,H", [(1, 1, 1, 1, 1), (2, 21, 19, 5, 3), (3, 70, 45, 33, 2)])
def test_cross_gram_matches_jax(O, M, B, D, H):
    z, x, theta = _gram_inputs(B, O, M, D, H, B)
    got = trbf.cross_gram(_t(theta), _t(z), _t(x)).numpy()
    want = np.asarray(jrbf.cross_gram(jnp.asarray(theta), jnp.asarray(z), jnp.asarray(x)))
    assert got.shape == (H, O, M, B)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_sym_gram_plain_matches_pallas_interpret():
    """K1's plain version against the TPU kernel itself (interpret mode),
    at a ragged shape (rows padded 9 -> 16, columns to 128)."""
    from vargp_tpu.ops.pallas.rbf_gram import _sym_gram_4d

    z, _, theta = _gram_inputs(6, 2, 9, 7, 3)
    invs = np.exp(-theta[:, :-1])
    gamma2 = np.exp(2.0 * theta[:, -1])
    with jax.disable_jit(), mock.patch(
        "vargp_tpu.ops.pallas.rbf_gram.pl.pallas_call",
        functools.partial(pl.pallas_call, interpret=True),
    ):
        want = _sym_gram_4d.__wrapped__(*map(jnp.asarray, (z, invs, gamma2)))
    got = sym_gram(*map(_t, (z, invs, gamma2)))  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sym_gram_plain(*map(_t, (z, invs, gamma2))).numpy(),
                               got.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("precision,tol", [("HIGHEST", 1e-6), ("HIGH", 1e-4)])
def test_cross_gram_plain_matches_pallas_interpret(precision, tol):
    """K4's plain version against the TPU kernel (interpret mode), in full
    f32 and in the bf16x3 product the TPU path runs in production."""
    from jax.experimental.pallas import tpu as pltpu

    from vargp_tpu.ops.pallas.rbf_gram import _cross_gram_4d

    z, x, theta = _gram_inputs(5, 2, 21, 5, 3, 19)
    invs2 = np.exp(-2.0 * theta[:, :-1])
    gamma2 = np.exp(2.0 * theta[:, -1])
    with pltpu.force_tpu_interpret_mode():
        want = _cross_gram_4d(*map(jnp.asarray, (z, x, invs2, gamma2)),
                              precision=getattr(jax.lax.Precision, precision))
    got = cross_gram(*map(_t, (z, x, invs2, gamma2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    np.testing.assert_array_equal(cross_gram_plain(*map(_t, (z, x, invs2, gamma2))).numpy(),
                                  got.numpy())


def test_wrappers_reject_mixed_and_unknown_devices():
    z, x, theta = _gram_inputs(0, 1, 4, 3, 2, 2)
    invs = _t(np.exp(-theta[:, :-1]))
    g2 = _t(np.exp(theta[:, -1])).to("meta")
    with pytest.raises(ValueError, match="several devices"):
        sym_gram(_t(z), invs, g2)
    with pytest.raises(ValueError, match="no kernel for device"):
        cross_gram(*(t.to("meta") for t in (_t(z), _t(x), invs)), g2)


def test_hypers_and_gram_diag_match_jax():
    rng = np.random.default_rng(4)
    D, H = 6, 3
    params = jrbf.init_rbf(jax.random.key(3), D)
    prior = jrbf.RBFPrior(jnp.asarray(rng.standard_normal(D + 1).astype(f32)),
                          jnp.asarray(rng.standard_normal(D + 1).astype(f32) * 0.1))
    key = jax.random.key(5)
    want = jrbf.sample_hypers(key, params, H)
    eps = jax.random.normal(key, (H, D + 1), jnp.float32)  # the draw sample_hypers makes
    tparams = trbf.RBFParams(_t(params.log_mean), _t(params.log_logvar))
    tprior = trbf.RBFPrior(_t(prior.log_mean), _t(prior.log_logvar))
    theta = trbf.sample_hypers(tparams, _t(eps))
    np.testing.assert_allclose(theta.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(trbf.sample_hypers(tparams, _t(eps), map_est=True).numpy(),
                                  np.asarray(jrbf.sample_hypers(key, params, H, map_est=True)))
    np.testing.assert_allclose(float(trbf.kl_hypers(tparams, tprior)),
                               float(jrbf.kl_hypers(params, prior)), rtol=1e-6)
    assert float(trbf.kl_hypers(tparams, tprior, map_est=True)) == 0.0
    np.testing.assert_allclose(trbf.gram_diag(theta).numpy(),
                               np.asarray(jrbf.gram_diag(want)), rtol=1e-6)
    dp = trbf.default_prior(D, device="cpu")
    np.testing.assert_array_equal(dp.log_mean.numpy(), np.asarray(jrbf.default_prior(D).log_mean))


@pytest.mark.parametrize("weighted", [False, True])
def test_softmax_loss_and_predict_match_jax(weighted):
    rng = np.random.default_rng(int(weighted))
    H, n_f, O, B = 2, 5, 4, 7
    mu = rng.standard_normal((H, O, B)).astype(f32)
    var = rng.random((H, O, B)).astype(f32) * 2.0
    y = rng.integers(0, O, B)
    w = (rng.random(B) > 0.3).astype(f32) if weighted else None
    key = jax.random.key(11)
    eps = jax.random.normal(key, (H, n_f, O, B), jnp.float32)  # the draw softmax makes
    want = jsoft.softmax_loss(key, jnp.asarray(mu), jnp.asarray(var), jnp.asarray(y), n_f,
                              weights=None if w is None else jnp.asarray(w))
    got = tsoft.softmax_loss(_t(mu), _t(var), _t(y), _t(eps), weights=None if w is None else _t(w))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    want_p = jsoft.softmax_predict(key, jnp.asarray(mu), jnp.asarray(var), n_f)
    got_p = tsoft.softmax_predict(_t(mu), _t(var), _t(eps))
    assert got_p.shape == (B, O)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-6, atol=1e-7)


def _close_to_scale(got, want, tol=1e-5, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(float(np.max(np.abs(want))), 1e-30),
                               err_msg=name)


@pytest.mark.parametrize("O,M,D,H", [(2, 9, 7, 3), (1, 140, 5, 2)])
def test_sym_gram_tri_plain_matches_pallas_interpret(O, M, D, H):
    """K2's plain version against the TPU kernel itself (interpret mode):
    one 128-row panel, and two with a partial last panel."""
    from vargp_tpu.ops.pallas.rbf_gram import _sym_gram_4d_tri

    z, _, theta = _gram_inputs(M, O, M, D, H)
    invs = np.exp(-theta[:, :-1])
    gamma2 = np.exp(2.0 * theta[:, -1])
    with jax.disable_jit():
        want = _sym_gram_4d_tri.__wrapped__(*map(jnp.asarray, (z, invs, gamma2)),
                                            interpret=True)
    got = sym_gram_tri(*map(_t, (z, invs, gamma2)))  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.numpy(), sym_gram_plain(*map(_t, (z, invs, gamma2))).numpy())


def test_sym_gram_routes_as_the_jax_package(monkeypatch):
    """K2 from 512 chain rows up and K1 below, at the same S as the JAX
    package's gate on its Pallas backend."""
    from vargp_tpu.ops import dispatch as jdispatch
    from vargp_tpu.ops.pallas import rbf_gram as jrg

    monkeypatch.setattr(jdispatch, "_BACKEND", "pallas")
    jax_route, port_route = [], []
    monkeypatch.setattr(jrg, "_sym_gram_4d_tri", lambda *a, **k: jax_route.append("K2"))
    monkeypatch.setattr(jrg, "_sym_gram_4d", lambda *a, **k: jax_route.append("K1"))
    monkeypatch.setattr(trbf, "_sym_gram_tri_kernel", lambda *a: port_route.append("K2"))
    monkeypatch.setattr(trbf, "_sym_gram_kernel", lambda *a: port_route.append("K1"))
    for M in (1, 300, 511, 512, 1000):
        z, _, theta = _gram_inputs(0, 1, M, 3, 2)
        jrg._sym_gram_impl(jnp.asarray(z), jnp.asarray(np.exp(-theta[:, :-1])),
                           jnp.asarray(np.exp(2 * theta[:, -1])))
        trbf._sym_gram_impl(_t(z), _t(np.exp(-theta[:, :-1])), _t(np.exp(2 * theta[:, -1])))
    assert port_route == jax_route == ["K1", "K1", "K1", "K2", "K2"]


@pytest.mark.parametrize("O,M,D,H", [(2, 70, 9, 3), (1, 520, 6, 2)])
def test_sym_gram_backward_matches_jax_rule(O, M, D, H):
    """The autograd rule against ``_sym_gram_bwd`` on the same residuals;
    M = 520 runs the K2 route."""
    from vargp_tpu.ops.pallas.rbf_gram import _sym_gram_bwd

    rng = np.random.default_rng(M)
    z, _, theta = _gram_inputs(M + 1, O, M, D, H)
    invs = np.exp(-theta[:, :-1]).astype(f32)
    gamma2 = np.exp(2.0 * theta[:, -1]).astype(f32)
    g = rng.standard_normal((H, O, M, M)).astype(f32)
    leaves = [_t(a).requires_grad_() for a in (z, invs, gamma2)]
    K = trbf._SymGram.apply(*leaves)
    got = torch.autograd.grad(K, leaves, _t(g))
    want = _sym_gram_bwd(jax.lax.Precision.HIGHEST,
                         tuple(map(jnp.asarray, (z, invs, gamma2, K.detach().numpy()))),
                         jnp.asarray(g))
    for name, a, b in zip(("z", "invs", "gamma2"), got, want):
        _close_to_scale(a.numpy(), b, name=name)


def test_cross_gram_backward_matches_jax_rule_and_gives_x_nothing():
    from vargp_tpu.kernels.rbf import _cross_gram_p_bwd

    O, M, B, D, H = 2, 37, 21, 9, 3
    rng = np.random.default_rng(9)
    z, x, theta = _gram_inputs(9, O, M, D, H, B)
    invs2 = np.exp(-2.0 * theta[:, :-1]).astype(f32)
    gamma2 = np.exp(2.0 * theta[:, -1]).astype(f32)
    g = rng.standard_normal((H, O, M, B)).astype(f32)
    leaves = [_t(a).requires_grad_() for a in (z, x, invs2, gamma2)]
    K = trbf._CrossGram.apply(*leaves)
    K.backward(_t(g))
    xs = x[None] * invs2[:, None, :]
    res = tuple(map(jnp.asarray, (z, x, invs2, gamma2, xs, K.detach().numpy())))
    dz, dx, d_invs2, d_gamma2 = _cross_gram_p_bwd(jax.lax.Precision.HIGHEST, res, jnp.asarray(g))
    assert leaves[1].grad is None and not np.any(np.asarray(dx))  # x is data: no cotangent
    for name, leaf, want in (("z", leaves[0], dz), ("invs2", leaves[2], d_invs2),
                             ("gamma2", leaves[3], d_gamma2)):
        _close_to_scale(leaf.grad.numpy(), want, name=name)
    # through theta, x still gets nothing
    xt = _t(x).requires_grad_()
    trbf.cross_gram(_t(theta).requires_grad_(), _t(z), xt).sum().backward()
    assert xt.grad is None


def test_init_rbf_matches_jax():
    D = 7
    key = jax.random.key(4)
    want = jrbf.init_rbf(key, D)
    eps = jax.random.normal(key, (D + 1,), jnp.float32)  # the draw init_rbf makes
    got = trbf.init_rbf(_t(eps))
    np.testing.assert_allclose(got.log_mean.numpy(), np.asarray(want.log_mean), rtol=1e-6)
    np.testing.assert_array_equal(got.log_logvar.numpy(), np.asarray(want.log_logvar))


def _prescaled(seed, G, M, N, D):
    rng = np.random.default_rng(seed)
    sx = (rng.standard_normal((G, M, D)) / np.sqrt(D)).astype(f32)
    sy = (rng.standard_normal((G, N, D)) / np.sqrt(D)).astype(f32)
    gamma2 = np.exp(rng.standard_normal(G) * 0.2).astype(f32)
    return sx, sy, gamma2


@pytest.mark.parametrize("G,M,N,D", [(3, 37, 70, 64), (2, 130, 9, 5), (1, 1, 1, 1)])
def test_rbf_gram_plain_matches_pallas_interpret(G, M, N, D):
    """K5's plain version against ``_gram_3d`` itself (interpret mode) on
    ragged shapes: rows and columns padded to 128 there, masked here."""
    from jax.experimental.pallas import tpu as pltpu

    from vargp_tpu.ops.pallas.rbf_gram import _gram_3d

    sx, sy, gamma2 = _prescaled(M + N, G, M, N, D)
    with pltpu.force_tpu_interpret_mode():
        want = _gram_3d(*map(jnp.asarray, (sx, sy, gamma2)))
    got = rbf_gram(*map(_t, (sx, sy, gamma2)))  # CPU tensors: the plain version
    assert got.shape == (G, M, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(rbf_gram_plain(*map(_t, (sx, sy, gamma2))).numpy(), got.numpy())


@pytest.mark.parametrize("same", [False, True])
def test_rbf_gram_backward_matches_jax_vjp(same):
    """The cotangents of sx, sy and gamma2 against ``jax.vjp`` of
    ``rbf_gram_pallas`` (whose rule is ``_rbf_gram_bwd``); with sx passed
    as both sides, as the deep kernel's K_zz does, the two sides' cotangents
    add up on both."""
    from vargp_tpu.ops.pallas.rbf_gram import rbf_gram_pallas

    G, M, N, D = 3, 37, 70, 64
    sx, sy, gamma2 = _prescaled(7, G, M, N, D)
    if same:
        sy = sx
    g = np.random.default_rng(8).standard_normal((G, M, sy.shape[1])).astype(f32)
    if same:
        want_K, vjp = jax.vjp(lambda a, c: rbf_gram_pallas(a, a, c),
                              jnp.asarray(sx), jnp.asarray(gamma2[:, None, None]))
        want = (*vjp(jnp.asarray(g)),)
        leaves = [_t(sx).requires_grad_(), _t(gamma2).requires_grad_()]
        K = tdispatch.rbf_gram(leaves[0], leaves[0], leaves[1])
        names = ("sx", "gamma2")
    else:
        want_K, vjp = jax.vjp(rbf_gram_pallas, jnp.asarray(sx), jnp.asarray(sy),
                              jnp.asarray(gamma2[:, None, None]))
        want = vjp(jnp.asarray(g))
        leaves = [_t(a).requires_grad_() for a in (sx, sy, gamma2)]
        K = tdispatch.rbf_gram(*leaves)
        names = ("sx", "sy", "gamma2")
    np.testing.assert_allclose(K.detach().numpy(), np.asarray(want_K), rtol=1e-5, atol=1e-6)
    got = torch.autograd.grad(K, leaves, _t(g))
    for name, a, b in zip(names, got, want):
        _close_to_scale(a.numpy(), np.asarray(b).reshape(a.shape), name=name)


@pytest.mark.parametrize("x_shape,y_rows", [((9, 5), None), ((2, 21, 7), 13), ((2, 3, 11, 4), None)])
def test_gram_matches_jax(x_shape, y_rows):
    """The generic Gram with the per-hyper-sample scaling, over 0 to 2
    batch axes, y = x or another input."""
    rng = np.random.default_rng(len(x_shape))
    D, H = x_shape[-1], 3
    x = (rng.standard_normal(x_shape) * 0.4).astype(f32)
    y = None if y_rows is None else (rng.standard_normal((*x_shape[:-2], y_rows, D)) * 0.4).astype(f32)
    theta = (rng.standard_normal((H, D + 1)) * 0.2).astype(f32)
    want = jrbf.gram(jnp.asarray(theta), jnp.asarray(x), None if y is None else jnp.asarray(y))
    got = trbf.gram(_t(theta), _t(x), None if y is None else _t(y))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_rbf_gram_rejects_mismatched_batches():
    sx, sy, gamma2 = _prescaled(0, 2, 4, 5, 3)
    with pytest.raises(ValueError, match="rbf_gram"):
        tdispatch.rbf_gram(_t(sx), _t(sy[:1]), _t(gamma2))
    with pytest.raises(ValueError, match="several devices"):
        rbf_gram(_t(sx), _t(sy), _t(gamma2).to("meta"))
