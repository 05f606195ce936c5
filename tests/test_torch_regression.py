"""The port's Gaussian likelihood (``likelihoods/gaussian.py``) and
regression driver (``experiments/regression.py``) against the JAX
package's on the CPU.

Small cases: M = 8 inducing points, N = 32 points of the driver's 1-D
function, 3 hyper samples.  Tolerances: the ELBO and the likelihood's
loss to 1e-5 relative, each leaf's gradient to 2e-5 of its largest
magnitude, in float64 on both sides (the JAX side under
``jax.enable_x64`` on its float64 draws) and, in f32, against the exact
values on the same draws within that limit or twice the JAX package's own
f32 distance from them.  Yogi's state after a few steps, and the driver's
parameters after a few epochs with the JAX keys replayed, to 1e-6 and
1e-5.  The driver itself reaches RMSE < 0.3 at 300 epochs, M = 16, as
``tests/test_experiments.py::test_regression_driver`` asks of the JAX
one.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tests import _torch_cases as C
from vargp_tpu import gpmath as jgm
from vargp_tpu.experiments import regression as JReg
from vargp_tpu.kernels import default_prior, init_rbf, kl_hypers
from vargp_tpu.likelihoods import gaussian as JGa
from vargp_tpu_torch.experiments import cli
from vargp_tpu_torch.experiments import regression as TReg
from vargp_tpu_torch.kernels import RBFPrior
from vargp_tpu_torch.kernels import init_rbf as init_rbf_t
from vargp_tpu_torch.likelihoods import gaussian as TGa
from vargp_tpu_torch.train import loop as TL
from vargp_tpu_torch.train.optim import OptState, Yogi, tree_leaves, tree_unflatten
from vargp_tpu_torch.utils import convert

RTOL = 1e-5
TOL_GRAD = 2e-5
N, M, H = 32, 8, 3
LEAVES = ("kernel.log_mean", "kernel.log_logvar", "lik.obs_log_var", "u_mean", "u_tril_vec", "z")


def _case(seed=0):
    """The JAX driver's initial parameter dict at M = 8 on N = 32 points of
    its function, moved off the initial values (u_mean, u_tril_vec, the
    noise), and its prior."""
    rng = np.random.default_rng(seed)
    x, y = JReg._make_data(rng, N)
    idx = rng.permutation(N)[:M]
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))
    params = dict(
        z=f32(x[idx])[None], u_mean=f32(0.3 * rng.standard_normal((1, M, 1))),
        u_tril_vec=f32(0.5 + 0.1 * rng.standard_normal((1, M * (M + 1) // 2))),
        kernel=init_rbf(jax.random.key(seed), 1),
        lik=JGa.GaussianLikParams(f32([-3.0])))
    return params, default_prior(1), f32(x), f32(y)


def _jax_total(p, prior, x, y, k, n_v=H):
    """The JAX driver's step loss (``regression.py``'s ``total``)."""
    mu, var, (L, u_tril) = JReg._forward(p, x, k, n_v)
    nll = JGa.gaussian_loss(p["lik"], mu, var, y)
    kl = jgm.mvn_kl(p["u_mean"][..., 0], u_tril, jnp.zeros_like(p["u_mean"][..., 0]), L)
    return kl_hypers(p["kernel"], prior) + jnp.mean(jnp.sum(kl, axis=-1)) + nll, nll


def _jax_value_and_grad(f64, key):
    params, prior, x, y = _case()
    with jax.enable_x64(f64):
        cast = C.to_f64 if f64 else (lambda t: t)
        (lv, nll), g = jax.jit(jax.value_and_grad(
            lambda p: _jax_total(p, cast(prior), cast(x), cast(y), key), has_aux=True))(
            cast(params))
        hyper = jax.random.normal(key, (H, 2), jnp.float64 if f64 else jnp.float32)
        return (float(lv), float(nll)), [np.asarray(a) for a in jax.tree_util.tree_leaves(g)], \
            torch.tensor(np.asarray(hyper))


def _port_value_and_grad(dtype, hyper):
    params, prior, x, y = _case()
    tp, _, tprior = convert.params_from_numpy(C.np_tree(params), (), C.np_tree(prior),
                                              device="cpu")
    cast = lambda tree: tree_unflatten(tree, [a.to(dtype) for a in tree_leaves(tree)])
    tp, tprior = cast(tp), cast(tprior)
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    total, (nll,) = TReg.elbo(tree_unflatten(tp, leaves), tprior,
                              torch.tensor(np.asarray(x)).to(dtype),
                              torch.tensor(np.asarray(y)).to(dtype), hyper.to(dtype))
    grads = torch.autograd.grad(total, leaves)
    return (float(total.detach()), float(nll.detach())), [g.double().numpy() for g in grads]


@pytest.mark.parametrize("f64", [True, False])
def test_gaussian_loss_and_predict_match_jax(f64):
    """``gaussian_loss`` (mean over hypers and outputs, sum over the batch)
    and ``gaussian_predict`` (the mean) on the same moments and targets."""
    rng = np.random.default_rng(1)
    dt = np.float64 if f64 else np.float32
    mu, var = rng.standard_normal((3, 2, 20)).astype(dt), rng.random((3, 2, 20)).astype(dt)
    y, lv = rng.standard_normal((2, 20)).astype(dt), np.array([-3.0, -1.5], dt)
    with jax.enable_x64(f64):
        want = float(JGa.gaussian_loss(JGa.GaussianLikParams(jnp.asarray(lv)), jnp.asarray(mu),
                                       jnp.asarray(var), jnp.asarray(y)))
    t = torch.tensor
    p = TGa.GaussianLikParams(t(lv))
    got = float(TGa.gaussian_loss(p, t(mu), t(var), t(y)))
    np.testing.assert_allclose(got, want, rtol=RTOL if not f64 else 1e-12)
    assert torch.equal(TGa.gaussian_predict(p, t(mu), t(var)), t(mu))
    init = TGa.init_gaussian(3, device="cpu")
    np.testing.assert_array_equal(init.obs_log_var.numpy(), np.asarray(JGa.init_gaussian(3)[0]))


@pytest.mark.parametrize("precision", ["float64", "f32"])
def test_step_loss_and_gradients_match_jax(precision):
    """The driver's step loss, its nll and every leaf's gradient (the
    fields in the JAX dict's sorted order) on the JAX key's draws."""
    f64 = precision == "float64"
    key = jax.random.key(4)
    want, want_g, hyper = _jax_value_and_grad(f64, key)
    got, got_g = _port_value_and_grad(torch.float64 if f64 else torch.float32, hyper)
    if f64:
        np.testing.assert_allclose(got, want, rtol=RTOL)
        refs = want_g
    else:
        exact, refs = _port_value_and_grad(torch.float64, hyper)
        for g, e, w in zip(got, exact, want):
            np.testing.assert_allclose(g, e, rtol=0, atol=max(RTOL * abs(e), 2 * abs(w - e)))
    for k, (name, g, r) in enumerate(zip(LEAVES, got_g, refs)):
        scale = max(float(np.max(np.abs(r))), 1e-30)
        atol = TOL_GRAD * scale
        if not f64:
            atol = max(atol, 2.0 * float(np.max(np.abs(want_g[k] - r))))
        np.testing.assert_allclose(g, r, rtol=0, atol=atol, err_msg=name)


def test_yogi_state_after_steps_matches_optax():
    """Four steps of the port's (``gradient_step`` on ``elbo``) and of the
    JAX driver's step (``optax.yogi(1e-2)`` on the dict) on the same keys,
    in float64: the
    parameters and the Yogi state (count, mu, nu) leaf for leaf, the state
    carried over from optax's by ``convert``."""
    params, prior, x, y = _case()
    keys = jax.random.split(jax.random.key(7), 4)
    with jax.enable_x64(True):
        p, pr, xx, yy = (C.to_f64(a) for a in (params, prior, x, y))
        tx = optax.yogi(1e-2)
        state = tx.init(p)

        @jax.jit
        def jstep(p, state, k):
            g = jax.grad(lambda q: _jax_total(q, pr, xx, yy, k)[0])(p)
            up, state = tx.update(g, state, p)
            return optax.apply_updates(p, up), state

        hypers = []
        for k in keys:
            hypers.append(torch.tensor(np.asarray(jax.random.normal(k, (H, 2), jnp.float64))))
            p, state = jstep(p, state, k)
        want_p, want_s = C.np_tree(p), C.np_tree(state[0])
    tp, _, tprior = convert.params_from_numpy(C.np_tree(params), (), C.np_tree(prior),
                                              device="cpu")
    tp = tree_unflatten(tp, [a.double() for a in tree_leaves(tp)])
    tprior = tree_unflatten(tprior, [a.double() for a in tree_leaves(tprior)])
    opt = Yogi(1e-2)
    ts = opt.init(tp)
    tx_, ty_ = torch.tensor(np.asarray(x)).double(), torch.tensor(np.asarray(y)).double()
    for h in hypers:
        tp, ts, _, _ = TL.gradient_step(tp, ts, lambda p: TReg.elbo(p, tprior, tx_, ty_, h), opt)
    conv = convert.opt_state_from_numpy(want_s, device="cpu")
    assert isinstance(conv, OptState) and type(conv.mu).__name__ == "RegressionParams"
    assert int(ts.count) == int(conv.count) == 4
    for g, w in zip(tree_leaves(tp) + tree_leaves(ts.mu) + tree_leaves(ts.nu),
                    jax.tree_util.tree_leaves((want_p, want_s.mu, want_s.nu))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-12)
    back = convert.params_to_numpy(tp)
    assert isinstance(back, dict) and sorted(back) == ["kernel", "lik", "u_mean", "u_tril_vec",
                                                       "z"]


class JaxRegressionDraws:
    """The JAX driver's draws at ``seed``: k_init split first off the
    seed's key, then one key split off per step and for the final
    evaluation, each drawing (n, 2) hyper noise."""

    def __init__(self, seed):
        self.k_init, self.key = jax.random.split(jax.random.key(seed))

    def init(self):
        return torch.tensor(np.asarray(jax.random.normal(self.k_init, (2,))))

    def hypers(self, n):
        self.key, k = jax.random.split(self.key)
        return torch.tensor(np.asarray(jax.random.normal(k, (n, 2))))


def _exact_driver(epochs, M, seed):
    """The driver's loop in float64 on the JAX driver's draws: the same
    data, inducing rows and initial values, the port's step
    (``gradient_step`` on ``elbo``) and ``_forward``.  Returns (params,
    rmse)."""
    rng = np.random.default_rng(seed)
    x, y = (torch.from_numpy(a).double() for a in TReg._make_data(rng))
    idx = rng.permutation(len(x))[:M]
    draws = JaxRegressionDraws(seed)
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float32).double()
    params = TReg.RegressionParams(
        kernel=init_rbf_t(f64(draws.init())), lik=TGa.GaussianLikParams(f64([-4.0])),
        u_mean=torch.zeros((1, M, 1), dtype=torch.float64),
        u_tril_vec=torch.full((1, M * (M + 1) // 2), 0.5, dtype=torch.float64), z=x[idx][None])
    prior = RBFPrior(torch.zeros(2, dtype=torch.float64), torch.zeros(2, dtype=torch.float64))
    opt = Yogi(1e-2)
    state = opt.init(params)
    for _ in range(epochs):
        h = f64(draws.hypers(H))
        params, state, _, _ = TL.gradient_step(params, state,
                                               lambda p: TReg.elbo(p, prior, x, y, h), opt)
    mu, var, _ = TReg._forward(params, x, f64(draws.hypers(16)))
    pred = mu.mean(0)[0]
    return params, float(torch.sqrt(torch.mean(torch.square(pred - y[0]))))


def test_driver_replays_the_jax_driver(tmp_path):
    """``regression`` on the JAX driver's draws (5 epochs, M = 8): the same
    data, inducing rows and initial values; the final parameters and the
    RMSE held to the exact ones (the same loop in float64 on the same
    draws) within 1e-5, or twice the JAX driver's own f32 distance from
    them.  Its 8 inducing rows of 256 sorted points include close pairs:
    K_zz's condition number reaches ~1e4, and each package's f32 Yogi path
    parts from the exact one by up to 1e-4 within 5 steps."""
    want_p, want_rmse = JReg.regression(epochs=5, M=8, seed=0, log_dir=str(tmp_path / "jax"))
    got_p, got_rmse = TReg.regression(epochs=5, M=8, seed=0, log_dir=str(tmp_path / "port"),
                                      device="cpu", draws=JaxRegressionDraws(0))
    exact_p, exact_rmse = _exact_driver(5, 8, 0)
    leaves = jax.tree_util.tree_leaves(want_p)
    assert len(leaves) == len(tree_leaves(got_p)) == 6
    for name, g, w, e in zip(LEAVES, tree_leaves(got_p), leaves, tree_leaves(exact_p)):
        e = e.numpy()
        lim = max(1e-5, 2.0 * float(np.max(np.abs(np.asarray(w, np.float64) - e))))
        np.testing.assert_allclose(g.double().numpy(), e, rtol=0, atol=lim, err_msg=name)
    lim = max(1e-5, 2.0 * abs(want_rmse - exact_rmse))
    np.testing.assert_allclose(got_rmse, exact_rmse, rtol=0, atol=lim)


def test_regression_driver_fits(tmp_path):
    """300 epochs at M = 16 on the CPU: train RMSE below 0.3 (noise sigma
    0.1), the loss logged every 100 epochs and finite."""
    _, rmse = TReg.regression(epochs=300, M=16, seed=0, log_dir=str(tmp_path), device="cpu")
    assert rmse < 0.3
    with open(tmp_path / "metrics.jsonl") as f:
        rows = f.read().splitlines()
    assert len(rows) == 3 and all('"regression/loss"' in r for r in rows)


def test_cli_runs_regression(tmp_path, capsys):
    assert cli.main(["regression", "--epochs=3", "--M=4", "--device=cpu",
                     f"--log_dir={tmp_path}"]) == 0
    assert "[regression] train RMSE" in capsys.readouterr().out


@pytest.mark.parametrize("call", ["regression", "init_gaussian"])
def test_entry_points_need_a_card_unless_asked(call, tmp_path):
    """With no card, device=None raises before any work or file."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if call == "regression":
            TReg.regression(log_dir=str(tmp_path))
        else:
            TGa.init_gaussian(1)
    assert not os.listdir(tmp_path)
