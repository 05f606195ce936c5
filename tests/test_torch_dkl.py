"""The deep-kernel (DKL) VAR-GP of the port against the JAX package on the
CPU: the MLP and its initialisation, the deep Gram, ``loss`` and
``predict``, every gradient of ``loss`` (the feature map's leaves
included), Yogi steps with the optimizer state carried in from optax, and
the train block.

The case is ``tests/_torch_cases.py``'s small one (3 classes, M = 64, a
3-task chain, S = 192, B = 32, 2 hyper samples) under the deep kernel:
phi = 16 -> 256 -> 256 -> 64 from the JAX package's own ``init_mlp``,
the last layer scaled by ``PHI_GAIN`` (see there).  Both sides get the
same parameters and the JAX package's own noise.

Tolerances, as for the plain model (``test_torch_vargp.py``,
``test_torch_grad.py``): both sides run f32 and differ by summation order
only, so the ELBO pieces agree to 1e-5 relative, each gradient leaf to
2e-5 of its largest magnitude.  Probabilities agree to 1e-5 absolute, the
level-1 bound of the minted chains (``test_torch_analysis.py``): the
MLP's 256-wide products add their own rounding before the Gram (the
largest error seen is 1.4e-6, where the plain model stays under 1e-6).
Three Yogi steps leave the parameters within 2e-5, under 1% of what
they can move them (lr = 3e-3; the largest error seen is 7.6e-6, on one
element of phi's second bias, where Yogi divides a gradient's rounding
error by a small second moment).  The optimizer moments hold the
gradients' error: mu within 2e-5 of each leaf's largest moment, nu
(squares of gradients) within 4e-5.

The last bias of phi shifts every feature alike, and the RBF kernel sees
only differences of features: its gradient is exactly 0, and each
package returns rounding noise there.  That leaf is held to 0 on both
sides, within the tolerance of the largest bias gradient of phi; in the
steps, where Yogi normalises that noise into moves of up to lr, to at
most 3 lr on both sides.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tests import _torch_cases as C
from vargp_tpu.kernels import deep as jdeep
from vargp_tpu.models import vargp as JV
from vargp_tpu.train import loop as JL
from vargp_tpu_torch.kernels import deep as tdeep
from vargp_tpu_torch.models import vargp as TV
from vargp_tpu_torch.train import loop as TL
from vargp_tpu_torch.train.optim import Yogi, tree_leaves, tree_unflatten
from vargp_tpu_torch.utils import convert

f32 = np.float32
LR = 3e-3
RTOL_LOSS = 1e-5
ATOL_PROBS = 1e-5
TOL_GRAD = 2e-5

_jit_loss = jax.jit(JV.loss, static_argnames=("cfg",))
_jit_predict = jax.jit(JV.predict, static_argnames=("cfg", "n_f", "n_var_samples"))


@pytest.fixture(scope="module")
def model():
    return C.build_dkl("small")


def _t(a):
    return torch.tensor(np.asarray(a))


def _leaf_names(tree):
    return [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


SHIFT = ".phi.biases[2]"  # the kernel is invariant to it: its gradient is 0


def _close_to_scale(got, want, tol, name, scale=None):
    want = np.asarray(want)
    scale = float(np.max(np.abs(want))) if scale is None else scale
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * max(scale, 1e-30),
                               err_msg=name)


def _close_by_leaf(names, got, want, tol, what):
    """Each leaf to ``tol`` of its largest magnitude; the shift-invariant
    bias to 0 on both sides, within ``tol`` of phi's largest bias value."""
    want = [np.asarray(w) for w in want]
    bias_scale = max((float(np.max(np.abs(w))) for n, w in zip(names, want)
                      if n.startswith(".phi.biases") and n != SHIFT), default=0.0)
    for name, g, w in zip(names, got, want):
        if name == SHIFT:
            _close_to_scale(g, np.zeros_like(w), tol, f"{what} {name} (port)", bias_scale)
            _close_to_scale(w, np.zeros_like(w), tol, f"{what} {name} (JAX)", bias_scale)
        else:
            _close_to_scale(g, w, tol, f"{what} {name}")


def _jax_mlp_draws(key, dims):
    """The U[0, 1) draws ``jdeep.init_mlp`` makes from ``key``."""
    draws = []
    for i in range(len(dims) - 1):
        key, wk, bk = jax.random.split(key, 3)
        draws += [jax.random.uniform(wk, (dims[i], dims[i + 1])),
                  jax.random.uniform(bk, (dims[i + 1],))]
    return draws


@pytest.mark.parametrize("in_size,hidden,features", [(16, 256, 64), (784, 32, 8)])
def test_init_mlp_matches_jax(in_size, hidden, features):
    key = jax.random.key(in_size)
    want = jdeep.init_mlp(key, in_size, hidden, features)
    draws = _jax_mlp_draws(key, [in_size, hidden, hidden, features])
    got = tdeep.init_mlp([_t(u) for u in draws], in_size, hidden, features)
    assert _leaf_names(convert.params_to_numpy(got)) == _leaf_names(want)
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-8)
    with pytest.raises(ValueError, match="draws"):
        tdeep.init_mlp([_t(u) for u in draws[:-1]], in_size, hidden, features)


@pytest.mark.parametrize("shape", [(7, 16), (3, 5, 16)])
def test_mlp_apply_matches_jax(model, shape):
    phi = model["params"].phi
    x = np.random.default_rng(1).standard_normal(shape).astype(f32)
    want = jdeep.mlp_apply(phi, jnp.asarray(x))
    tphi = convert.params_from_numpy(C.np_tree(model["params"]), device="cpu")[0].phi
    got = tdeep.mlp_apply(tphi, _t(x))
    assert got.shape == (*shape[:-1], 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("with_y", [False, True])
def test_deep_gram_matches_jax(model, with_y):
    rng = np.random.default_rng(2)
    phi = model["params"].phi
    x = (rng.standard_normal((3, 21, 16)) * 0.3).astype(f32)
    y = (rng.standard_normal((3, 13, 16)) * 0.3).astype(f32) if with_y else None
    theta = (np.log(0.5) + rng.standard_normal((2, 65)) * 0.2).astype(f32)
    want = jdeep.deep_gram(phi, jnp.asarray(theta), jnp.asarray(x),
                           None if y is None else jnp.asarray(y))
    tphi = convert.params_from_numpy(C.np_tree(model["params"]), device="cpu")[0].phi
    got = tdeep.deep_gram(tphi, _t(theta), _t(x), None if y is None else _t(y))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["chain", "padded", "task0"])
@pytest.mark.parametrize("weighted", [False, True])
def test_dkl_loss_matches_jax(model, case, weighted):
    m = model
    prev, mask = C.chain(m, case)
    key = jax.random.key(1)
    w = m["w"] if weighted else None
    want = _jit_loss(m["params"], prev, m["prior"], m["x"], m["y"], key, cfg=m["cfg"],
                     weights=w, chain_mask=mask)
    tp, tprev, tprior, x, y, tw, noise, tmask = C.port_inputs(m, prev, mask, key)
    assert noise["hyper_eps"].shape[-1] == 65
    got = TV.loss(tp, tprev, tprior, x, y, noise, m["tcfg"], weights=tw if weighted else None,
                  chain_mask=tmask, device="cpu")
    for name, g, j in zip(("kl_hypers", "kl_u", "nll"), got, want):
        assert np.isfinite(float(g)), name
        np.testing.assert_allclose(float(g), float(j), rtol=RTOL_LOSS, err_msg=name)


@pytest.mark.parametrize("case,budgets", [
    ("chain", {}), ("padded", {}), ("task0", {}), ("padded", {"n_f": 6, "n_var_samples": 3}),
])
def test_dkl_predict_matches_jax(model, case, budgets):
    m = model
    prev, mask = C.chain(m, case)
    key = jax.random.key(2)
    want = _jit_predict(m["params"], prev, m["x"], key, cfg=m["cfg"], chain_mask=mask, **budgets)
    n_v, n_f = budgets.get("n_var_samples", 2), budgets.get("n_f", 4)
    k_fwd, k_lik = jax.random.split(key)  # the draws predict makes
    hyper = jax.random.normal(jax.random.split(k_fwd)[0], (n_v, 65), jnp.float32)
    lik = jax.random.normal(k_lik, (n_v, n_f, 3, 32), jnp.float32)
    tp, tprev, _, x, *_ , tmask = C.port_inputs(m, prev, mask, key)
    got = TV.predict(tp, tprev, x, convert.noise_for_predict(hyper, lik, device="cpu"),
                     m["tcfg"], chain_mask=tmask, device="cpu", **budgets).numpy()
    assert got.shape == (32, 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL_PROBS)


def _jax_grads(m, prev, mask, key):
    def pieces(p):
        return JV.loss(p, prev, m["prior"], m["x"], m["y"], key, m["cfg"],
                       weights=m["w"], chain_mask=mask)

    @jax.jit
    def run(params):
        out, vjp = jax.vjp(pieces, params)
        one_hot = [tuple(jnp.float32(i == j) for j in range(3)) for i in range(3)]
        return out, [vjp(c)[0] for c in one_hot]

    out, grads = run(m["params"])
    return [float(v) for v in out], [[np.asarray(g) for g in jax.tree_util.tree_leaves(gs)]
                                     for gs in grads]


@pytest.mark.parametrize("case", ["chain", "padded", "task0"])
def test_dkl_loss_gradients_match_jax(model, case):
    """Every leaf's gradient of each ELBO piece, the six leaves of phi
    included, against ``jax.vjp`` of the JAX package's ``loss``."""
    m = model
    prev, mask = C.chain(m, case)
    key = jax.random.key(3)
    want_out, want = _jax_grads(m, prev, mask, key)
    tp, tprev, tprior, x, y, w, noise, tmask = C.port_inputs(m, prev, mask, key)
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    names = _leaf_names(m["params"])
    assert len(leaves) == len(names) == 11
    out = TV.loss(tree_unflatten(tp, leaves), tprev, tprior, x, y, noise, m["tcfg"],
                  weights=w, chain_mask=tmask, device="cpu")
    for i, piece in enumerate(("kl_hypers", "kl_u", "nll")):
        np.testing.assert_allclose(float(out[i].detach()), want_out[i], rtol=RTOL_LOSS,
                                   err_msg=piece)
        got = torch.autograd.grad(out[i], leaves, retain_graph=True, allow_unused=True)
        got = [np.zeros_like(j) if g is None else g.numpy() for g, j in zip(got, want[i])]
        if piece == "kl_hypers":  # reads the kernel's posterior only: phi's gradients are 0
            assert all(not np.any(g) for n, g in zip(names, got) if n.startswith(".phi"))
            got, want[i], names_i = got[:5], want[i][:5], names[:5]
        else:
            names_i = names
        _close_by_leaf(names_i, got, want[i], TOL_GRAD, f"d {piece} /")


def test_dkl_elbo_steps_match_jax(model):
    """One JAX Yogi step, its optimizer state carried into the port (phi's
    moments included), then two more steps on each side with the JAX
    package's noise replayed; the parameters and both moments agree."""
    m = model
    beta, n_train = 10.0, 1000
    tx = optax.yogi(LR)
    step = jax.jit(partial(JL.elbo_step, cfg=m["cfg"], tx=tx, beta=beta, n_train=n_train))
    keys = [jax.random.key(30 + k) for k in range(3)]
    jp, js, *_ = step(m["params"], tx.init(m["params"]), m["prev"], m["prior"], m["x"], m["y"],
                      m["w"], keys[0])
    tp, tprev, tprior, x, y, w, _, _ = C.port_inputs(m, m["prev"], None, keys[0], params=jp)
    ts = convert.opt_state_from_numpy(C.np_tree(js[0]), device="cpu")
    assert len(tree_leaves(ts.mu)) == 11
    opt = Yogi(LR)
    for key in keys[1:]:
        jp, js, jloss, jaux = step(jp, js, m["prev"], m["prior"], m["x"], m["y"], m["w"], key)
        *_, noise, _ = C.port_inputs(m, m["prev"], None, key)
        tp, ts, tloss, taux = TL.elbo_step(tp, ts, tprev, tprior, x, y, w, noise, cfg=m["tcfg"],
                                           opt=opt, beta=beta, n_train=n_train, device="cpu")
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL_LOSS)
        for name, a, b in zip(("kl_hypers", "kl_u", "nll"), taux, jaux):
            np.testing.assert_allclose(float(a), float(b), rtol=RTOL_LOSS, err_msg=name)
    names = _leaf_names(jp)
    start = jax.tree_util.tree_leaves(m["params"])
    for name, a, b, a0 in zip(names, tree_leaves(convert.params_to_numpy(tp)),
                              jax.tree_util.tree_leaves(jp), start):
        if name == SHIFT:  # moved by normalised noise on both sides
            for moved in (a, np.asarray(b)):
                assert np.max(np.abs(moved - np.asarray(a0))) <= 3 * LR, name
        else:
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=2e-5, err_msg=name)
    out = convert.opt_state_to_numpy(ts)
    assert int(out.count) == int(js[0].count) == 3
    for moment, tol in (("mu", 2e-5), ("nu", 4e-5)):
        _close_by_leaf(names, tree_leaves(getattr(out, moment)),
                       jax.tree_util.tree_leaves(getattr(js[0], moment)), tol, moment)


def test_draw_noise_sizes_hyper_noise_by_the_kernel_inputs(model):
    """Under DKL the hyper samples have the features' 64 + 1 entries, not
    the data's D + 1: the train block's own draws must fit ``loss``."""
    m = model
    tcfg = m["tcfg"]
    tp, tprev, tprior, x, y, w, _, _ = C.port_inputs(m, m["prev"], None, jax.random.key(0))
    noise = TL.draw_noise(torch.Generator().manual_seed(0), tcfg, len(tprev), 32)
    assert tuple(noise["hyper_eps"].shape) == (tcfg.n_var_samples, 65)
    out = TV.loss(tp, tprev, tprior, x, y, noise, tcfg, weights=w, device="cpu")
    assert all(np.isfinite(float(v)) for v in out)


def test_dkl_train_block_is_a_loop_of_elbo_steps(model):
    """Two steps of the train block under DKL equal two ``elbo_step``s fed
    the block's permutation and noise."""
    m = model
    B = m["dims"]["B"]
    tp, tprev, tprior, *_ = C.port_inputs(m, m["prev"], None, jax.random.key(0))
    rng = np.random.default_rng(5)
    data = (rng.standard_normal((64, 16)) * 0.3).astype(f32)
    x, y, w = TL.pad_dataset_to_device(data, rng.integers(0, 3, 64), B, device="cpu")
    opt = Yogi(LR)
    kw = dict(cfg=m["tcfg"], opt=opt, beta=1.0, device="cpu")
    got_p, got_s, losses, _ = TL.train_block(
        tp, opt.init(tp), tprev, tprior, None, 64, x, y, w, torch.Generator().manual_seed(3),
        batch_size=B, n_epochs=1, **kw)
    p, s, want = tp, opt.init(tp), []
    for idx, noise in TL.GeneratorDraws(torch.Generator().manual_seed(3)).block(
            64, B, 1, m["tcfg"], len(tprev)):
        p, s, loss, _ = TL.elbo_step(p, s, tprev, tprior, x[idx], y[idx], w[idx], noise,
                                     n_train=64, **kw)
        want.append(loss)
    np.testing.assert_array_equal(losses.numpy(), torch.stack(want).numpy())
    for a, b in zip(tree_leaves(got_p), tree_leaves(p)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert len(tree_leaves(got_s.nu)) == 11 and bool(torch.isfinite(losses).all())


@pytest.mark.parametrize("warm", [False, True])
def test_dkl_init_params_matches_jax(model, warm):
    """A new task's parameters under DKL: the kernel over the 64 features,
    phi from the JAX package's uniform draws, or a copy of ``phi_init``."""
    m = model
    cfg, tcfg = m["cfg"], m["tcfg"]
    z = m["params"].z
    key = jax.random.key(6)
    kw = dict(phi_init=m["params"].phi, log_lengthscale_init=0.2) if warm else {}
    want_p, want_prior = JV.init_params(key, z, cfg, **kw)
    k_kern, k_u, k_phi = jax.random.split(key, 3)  # the draws init_params makes
    kernel_eps = jax.random.normal(k_kern, (65,), jnp.float32)
    u_eps = jax.random.normal(k_u, (3, 64, 1))
    tkw = {}
    if warm:
        tphi = convert.params_from_numpy(C.np_tree(m["params"]), device="cpu")[0].phi
        tkw = dict(phi_init=tphi, log_lengthscale_init=0.2)
    else:
        tkw = dict(phi_uniform=[_t(u) for u in _jax_mlp_draws(k_phi, [16, 256, 256, 64])])
    got_p, got_prior = TV.init_params(_t(kernel_eps), _t(u_eps), _t(z), tcfg, **tkw)
    for name, a, b in zip(_leaf_names(want_p), tree_leaves(convert.params_to_numpy(got_p)),
                          jax.tree_util.tree_leaves(want_p)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-8, err_msg=name)
    assert got_prior.log_mean.shape == (65,) == want_prior.log_mean.shape
    if warm:  # a copy: training the new task leaves the caller's phi as it was
        assert got_p.phi.weights[0] is not tkw["phi_init"].weights[0]
    with pytest.raises(ValueError, match="phi"):
        TV.init_params(_t(kernel_eps), _t(u_eps), _t(z), tcfg)


def test_convert_carries_phi_both_ways(model):
    """params and an optax Yogi state with phi, into the port and back,
    unchanged; the leaves in the JAX package's keystr order."""
    m = model
    tx = optax.yogi(LR)
    js = tx.init(m["params"])[0]
    tp, _, _ = convert.params_from_numpy(C.np_tree(m["params"]), device="cpu")
    ts = convert.opt_state_from_numpy(C.np_tree(js), device="cpu")
    back = convert.params_to_numpy(tp)
    assert _leaf_names(back) == _leaf_names(m["params"])
    for a, b in zip(tree_leaves(back), jax.tree_util.tree_leaves(m["params"])):
        np.testing.assert_array_equal(a, np.asarray(b))
    sback = convert.opt_state_to_numpy(ts)
    for a, b in zip(tree_leaves(sback.nu), jax.tree_util.tree_leaves(js.nu)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # the plain model keeps phi = None through the same functions
    plain = convert.params_from_numpy(C.np_tree(C.build("small")["params"]), device="cpu")[0]
    assert plain.phi is None and convert.params_to_numpy(plain).phi is None
    assert len(tree_leaves(plain)) == 5
