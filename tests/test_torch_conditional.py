"""The port's reference-parity conditionals (``gpmath/conditional.py``:
``gp_cond``, ``linear_joint``, ``linear_marginal_diag`` and its
``MarginalCache``) against the JAX package's on the CPU.

Inputs from a numpy seed: an RBF Gram of M = 7 inducing rows (jittered
by the factorisation), its cross Gram against N = 5 rows and their Gram,
batched over (2, 3) (two hyper samples, three classes); m (..., 7, 1), a
well-conditioned S = A A^T + I / 2, V and b.  Both sides factor with
jitter 1e-4 (the port through K7's plain version on the CPU).
Tolerance: 1e-5 of each output's largest magnitude (f32, different
factorisation and solve orders).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vargp_tpu import gpmath as jgm
from vargp_tpu_torch import gpmath as tgm

TOL = 1e-5
BATCH, M, N = (2, 3), 7, 5


def _case(seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    pts = rng.standard_normal((*BATCH, M + N, 3)).astype(f)
    d2 = np.sum((pts[..., :, None, :] - pts[..., None, :, :]) ** 2, axis=-1)
    K = (1.3 * np.exp(-0.5 * d2)).astype(f)
    A = rng.standard_normal((*BATCH, M, M)).astype(f) * 0.3
    return dict(
        Kzz=K[..., :M, :M], Kzx=K[..., :M, M:], Kxx=K[..., M:, M:],
        u=rng.standard_normal((*BATCH, M, 1)).astype(f),
        S=(A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(M)).astype(f),
        V=(0.2 * np.eye(N) + 0.01 * np.ones((N, N))).astype(f),
        b=rng.standard_normal((*BATCH, N, 1)).astype(f),
    )


def _close(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("given", ["nothing", "Lz", "Lz and Lz_Kzx"])
def test_gp_cond_matches_jax(given):
    c = _case()
    j = {k: jnp.asarray(v) for k, v in c.items()}
    t = {k: torch.tensor(v) for k, v in c.items()}
    jkw, tkw = {}, {}
    if given != "nothing":
        jkw["Lz"] = jgm.cholesky(j["Kzz"])
        tkw["Lz"] = torch.tensor(np.asarray(jkw["Lz"]))
    if given == "Lz and Lz_Kzx":
        jkw["Lz_Kzx"] = jgm.tri_solve(jkw["Lz"], j["Kzx"])
        tkw["Lz_Kzx"] = torch.tensor(np.asarray(jkw["Lz_Kzx"]))
    want = jgm.gp_cond(j["u"], j["Kzz"], j["Kzx"], j["Kxx"], **jkw)
    got = tgm.gp_cond(t["u"], t["Kzz"], t["Kzx"], t["Kxx"], **tkw)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("shared", [False, True])
def test_linear_joint_matches_jax(shared):
    """With S per batch entry, and one S broadcast over the batch."""
    c = _case(1)
    if shared:
        c["S"] = c["S"][0, 0]
    j = {k: jnp.asarray(v) for k, v in c.items()}
    t = {k: torch.tensor(v) for k, v in c.items()}
    want = jgm.linear_joint(j["u"], j["S"], j["Kzx"], j["Kzz"], j["V"], j["b"])
    got = tgm.linear_joint(t["u"], t["S"], t["Kzx"], t["Kzz"], t["V"], t["b"])
    for g, w in zip(got, want):
        _close(g, w)
    # the joint covariance is symmetric, its leading block S
    Sigma = got[1]
    _close(Sigma, np.swapaxes(Sigma.numpy(), -1, -2))
    _close(Sigma[..., :M, :M], np.broadcast_to(c["S"], (*BATCH, M, M)))


@pytest.mark.parametrize("return_cache", [False, True])
def test_linear_marginal_diag_matches_jax(return_cache):
    c = _case(2)
    j = {k: jnp.asarray(v) for k, v in c.items()}
    t = {k: torch.tensor(v) for k, v in c.items()}
    kxx = np.diagonal(c["Kxx"], axis1=-2, axis2=-1).copy()
    want = jgm.linear_marginal_diag(j["u"], j["S"], j["Kzz"], j["Kzx"], jnp.asarray(kxx),
                                    return_cache=return_cache)
    got = tgm.linear_marginal_diag(t["u"], t["S"], t["Kzz"], t["Kzx"], torch.tensor(kxx),
                                   return_cache=return_cache)
    assert len(got) == len(want) == (3 if return_cache else 2)
    _close(got[0], want[0])
    _close(got[1], want[1])
    if return_cache:
        assert isinstance(got[2], tgm.MarginalCache)
        _close(got[2].Lz, want[2].Lz)
        _close(got[2].Lz_Kzx, want[2].Lz_Kzx)


def test_marginal_diag_is_the_joint_covariance_diagonal():
    """linear_marginal_diag's variance is the diagonal of linear_joint's
    lower-right block with V = Kxx - Kxz Kzz^{-1} Kzx (gp_cond's Sigma),
    its mean the joint mean's tail with b = 0 and its S jittered as
    linear_marginal_diag factors it (S + 1e-4 I): the three oracles agree
    with each other in the port."""
    c = _case(3)
    t = {k: torch.tensor(v) for k, v in c.items()}
    _, Sigma_c = tgm.gp_cond(t["u"], t["Kzz"], t["Kzx"], t["Kxx"])
    mu_j, Sigma_j = tgm.linear_joint(t["u"], tgm.add_jitter(t["S"]), t["Kzx"], t["Kzz"], Sigma_c,
                                     torch.zeros(*BATCH, N, 1))
    mu_m, var_m = tgm.linear_marginal_diag(t["u"], t["S"], t["Kzz"], t["Kzx"],
                                           torch.diagonal(t["Kxx"], dim1=-2, dim2=-1))
    _close(mu_m, mu_j[..., M:, 0].numpy())
    _close(var_m, torch.diagonal(Sigma_j[..., M:, M:], dim1=-2, dim2=-1).numpy())
