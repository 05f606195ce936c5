"""The port's forward slice (``loss`` and ``predict``) against the JAX
package at a small configuration, on the CPU.

Both sides get the same parameters and the same random draws: the JAX
package's noise is replayed from its own key splits (``loss``/``predict``
split the key into forward and likelihood keys, ``forward`` splits the
former into hyper and prefix keys) and handed to the port through
``utils.convert``.  3 classes, M = 64 inducing points per task, D = 16,
B = 32, 2 hyper samples, 4 function samples; the 3-task chain (S = 192)
takes the blocked factorisation (2 blocks of 96), the padded chain
(S = 256) 2 blocks of 128.

Tolerances: both sides run f32 on the CPU and differ by summation order,
the Cholesky's column order and the products' association (the port's
K3 plain version is a right-looking column loop); relative 1e-5 on the
ELBO pieces (sums of 3 x 64 KL terms and 32 likelihood terms) and 1e-6
absolute on probabilities.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vargp_tpu import gpmath as jgm
from vargp_tpu.models import vargp as JV
from vargp_tpu_torch.models import vargp as TV
from vargp_tpu_torch.utils import convert

f32 = np.float32
O, M, D, B, H, N_F = 3, 64, 16, 32, 2, 4
RTOL_LOSS = 1e-5
ATOL_PROBS = 1e-6

_jit_loss = jax.jit(JV.loss, static_argnames=("cfg",))
_jit_predict = jax.jit(JV.predict, static_argnames=("cfg", "n_f", "n_var_samples"))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(0)
    prev = tuple(
        JV.TaskPosterior(
            z=jnp.asarray((rng.standard_normal((O, M, D)) * 0.3).astype(f32)),
            u_mean=jnp.asarray((rng.standard_normal((O, M, 1)) * 0.3).astype(f32)),
            u_tril=jgm.vec2tril(jnp.asarray((rng.standard_normal((O, M * (M + 1) // 2)) * 0.1).astype(f32))),
        )
        for _ in range(2)
    )
    cfg = JV.VARGPConfig(M=M, out_size=O, in_size=D, n_f=N_F, n_var_samples=H)
    z = jnp.asarray((rng.standard_normal((O, M, D)) * 0.3).astype(f32))
    params, prior = JV.init_params(jax.random.key(0), z, cfg)
    params = params._replace(u_tril_vec=params.u_tril_vec + jnp.asarray(
        (rng.standard_normal(params.u_tril_vec.shape) * 0.05).astype(f32)))
    prior = prior._replace(log_mean=prior.log_mean + 0.3)
    x = jnp.asarray((rng.standard_normal((B, D)) * 0.3).astype(f32))
    y = jnp.asarray(rng.integers(0, O, B))
    w = jnp.asarray((rng.random(B) > 0.2).astype(f32))
    tcfg = TV.VARGPConfig(M=M, out_size=O, in_size=D, n_f=N_F, n_var_samples=H)
    return dict(cfg=cfg, tcfg=tcfg, params=params, prior=prior, prev=prev, x=x, y=y, w=w)


def _jax_draws(key, c, n_v=H, n_f=N_F, with_prefix=True):
    """The draws the JAX path makes from ``key``: hyper samples, prefix
    draws of u_{<t} (when there is a chain) and function samples."""
    k_fwd, k_lik = jax.random.split(key)
    k_hyp, k_u = jax.random.split(k_fwd)
    hyper = jax.random.normal(k_hyp, (n_v, D + 1), jnp.float32)
    prefix = jax.random.normal(k_u, (n_v, n_v, O, c), jnp.float32) if with_prefix and c else None
    lik = jax.random.normal(k_lik, (n_v, n_f, O, B), jnp.float32)
    return hyper, prefix, lik


def _port(m, prev):
    return convert.params_from_numpy(_np(m["params"]), _np(prev), _np(m["prior"]), device="cpu")


def _chain(m, case):
    """(prev, chain_mask) of the JAX side for each chain case."""
    if case == "chain":
        return m["prev"], None
    if case == "task0":
        return (), None
    prev, mask = JV.pad_chain(m["prev"], m["cfg"], 4)  # 2 real tasks of 3 slots
    return prev, mask


@pytest.mark.parametrize("case", ["chain", "padded", "task0"])
@pytest.mark.parametrize("weighted", [False, True])
def test_loss_matches_jax(model, case, weighted):
    m = model
    prev, mask = _chain(m, case)
    w = m["w"] if weighted else None
    key = jax.random.key(1)
    want = _jit_loss(m["params"], prev, m["prior"], m["x"], m["y"], key, cfg=m["cfg"],
                     weights=w, chain_mask=mask)
    hyper, prefix, lik = _jax_draws(key, len(prev) * M)
    tp, tprev, tprior = _port(m, prev)
    noise = convert.noise_for_loss(hyper, prefix, lik, device="cpu")
    got = TV.loss(
        tp, tprev, tprior, torch.tensor(np.asarray(m["x"])), torch.tensor(np.asarray(m["y"])),
        noise, m["tcfg"], weights=None if w is None else torch.tensor(np.asarray(w)),
        chain_mask=None if mask is None else torch.tensor(np.asarray(mask)), device="cpu",
    )
    for name, g, j in zip(("kl_hypers", "kl_u", "nll"), got, want):
        assert np.isfinite(float(g)), name
        np.testing.assert_allclose(float(g), float(j), rtol=RTOL_LOSS, err_msg=name)


@pytest.mark.parametrize("case,budgets", [
    ("chain", {}), ("padded", {}), ("task0", {}), ("chain", {"n_f": 6, "n_var_samples": 3}),
])
def test_predict_matches_jax(model, case, budgets):
    m = model
    prev, mask = _chain(m, case)
    key = jax.random.key(2)
    want = _jit_predict(m["params"], prev, m["x"], key, cfg=m["cfg"], chain_mask=mask, **budgets)
    n_v = budgets.get("n_var_samples", H)
    hyper, _, lik = _jax_draws(key, 0, n_v=n_v, n_f=budgets.get("n_f", N_F), with_prefix=False)
    tp, tprev, _ = _port(m, prev)
    got = TV.predict(
        tp, tprev, torch.tensor(np.asarray(m["x"])),
        convert.noise_for_predict(hyper, lik, device="cpu"), m["tcfg"],
        chain_mask=None if mask is None else torch.tensor(np.asarray(mask)), device="cpu",
        **budgets,
    ).numpy()
    assert got.shape == (B, O)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL_PROBS)


def test_pad_chain_and_row_mask_match_jax(model):
    m = model
    jprev, jmask = JV.pad_chain(m["prev"], m["cfg"], 5)
    _, tprev, _ = _port(m, m["prev"])
    pprev, tmask = TV.pad_chain(tprev, m["tcfg"], 5, device="cpu")
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    for a, b in zip(pprev, jprev):
        for ta, jb in zip(a, b):
            np.testing.assert_array_equal(ta.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(
        TV._row_mask(tmask, M).numpy(), np.asarray(JV._row_mask(jmask, M))
    )
    with pytest.raises(ValueError):
        TV.pad_chain(tprev, m["tcfg"], 2, device="cpu")


def test_eval_budget_cfg_matches_jax(model):
    cfg, tcfg = model["cfg"], model["tcfg"]
    assert TV.eval_budget_cfg(tcfg) is tcfg
    for kw in ({"n_f": 7}, {"n_var_samples": 5}, {"n_f": 2, "n_var_samples": 1}):
        j, t = JV.eval_budget_cfg(cfg, **kw), TV.eval_budget_cfg(tcfg, **kw)
        assert (t.n_f, t.n_var_samples) == (j.n_f, j.n_var_samples)
    with pytest.raises(ValueError):
        TV.eval_budget_cfg(tcfg, n_f=0)


@pytest.mark.parametrize("override", [{"tril_layout": "filled"}])
def test_unported_forms_raise(model, override):
    from dataclasses import replace

    m = model
    tp, tprev, tprior = _port(m, m["prev"])
    hyper, prefix, lik = _jax_draws(jax.random.key(1), len(tprev) * M)
    with pytest.raises(NotImplementedError):
        TV.loss(tp, tprev, tprior, torch.tensor(np.asarray(m["x"])),
                torch.tensor(np.asarray(m["y"])),
                convert.noise_for_loss(hyper, prefix, lik, device="cpu"),
                replace(m["tcfg"], **override), device="cpu")


def test_noise_of_the_wrong_shape_raises(model):
    m = model
    tp, tprev, tprior = _port(m, m["prev"])
    hyper, prefix, lik = _jax_draws(jax.random.key(1), len(tprev) * M, n_f=N_F + 1)
    with pytest.raises(ValueError, match="lik_eps"):
        TV.loss(tp, tprev, tprior, torch.tensor(np.asarray(m["x"])),
                torch.tensor(np.asarray(m["y"])),
                convert.noise_for_loss(hyper, prefix, lik, device="cpu"), m["tcfg"], device="cpu")
    hyper, _, lik = _jax_draws(jax.random.key(1), len(tprev) * M)
    with pytest.raises(ValueError, match="prefix_eps"):
        TV.loss(tp, tprev, tprior, torch.tensor(np.asarray(m["x"])),
                torch.tensor(np.asarray(m["y"])),
                convert.noise_for_predict(hyper, lik, device="cpu"), m["tcfg"], device="cpu")


def test_entry_points_never_move_to_the_cpu_quietly(model):
    """device=None means the card: without one the call raises; with one,
    CPU tensors are refused rather than run on the CPU."""
    m = model
    tp, tprev, tprior = _port(m, m["prev"])
    hyper, prefix, lik = _jax_draws(jax.random.key(1), len(tprev) * M)
    noise = convert.noise_for_loss(hyper, prefix, lik, device="cpu")
    x, y = torch.tensor(np.asarray(m["x"])), torch.tensor(np.asarray(m["y"]))
    err = ValueError if torch.cuda.is_available() else RuntimeError
    with pytest.raises(err):
        TV.loss(tp, tprev, tprior, x, y, noise, m["tcfg"])
    with pytest.raises(err):
        TV.predict(tp, tprev, x, noise, m["tcfg"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            convert.params_from_numpy(_np(m["params"]), (), None)
