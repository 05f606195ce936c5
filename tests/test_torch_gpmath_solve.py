"""The rest of vargp_tpu_torch.gpmath against vargp_tpu.gpmath on the CPU,
the same numpy inputs on both sides: ``cholesky``, ``rev_cholesky``,
``tri_solve``, ``chol_solve``, ``mvn_log_prob``, ``mvn_sample``,
``mvn_kl`` by solves, the materialised AR posterior (the task fold with
and without L^-1, equal and unequal task blocks, and the block-LDL
build) and the marginal read from it (both branches, and the 2 x 2 split
of the L^-1 branch from 512 rows).

Tolerances: f32 on both sides, differing by summation order and the
factorisation's or solve's column order: 1e-5 relative (1e-6 absolute
near 0) on values of a well-conditioned chain (eigenvalues >= 0.5), 1e-4
relative on the marginal, whose variance is a difference of sums of up
to S = 512 squares, as test_torch_gpmath.py holds the factored marginal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vargp_tpu import gpmath as jgm
from vargp_tpu.gpmath import conditional as jcond
from vargp_tpu_torch import gpmath as tgm

f32 = np.float32
RTOL, ATOL = 1e-5, 1e-6
torch.set_num_threads(1)  # as tests/_torch_cases.py sets it


def _t(a):
    return torch.tensor(np.asarray(a))


def _j(a):
    return jnp.asarray(a)


def _spd(rng, batch, S, ridge=0.5):
    A = rng.standard_normal((*batch, S, S)).astype(f32)
    return (A @ np.swapaxes(A, -1, -2) / f32(S) + f32(ridge) * np.eye(S, dtype=f32)).astype(f32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


def test_cholesky_and_rev_cholesky_match_jax():
    K = _spd(np.random.default_rng(0), (2, 3), 150)
    L = tgm.cholesky(_t(K), 1e-3)
    _close(L, jgm.cholesky(_j(K), 1e-3))
    _close(tgm.rev_cholesky(L), jgm.rev_cholesky(_j(L.numpy())))


@pytest.mark.parametrize("transpose", [False, True])
def test_tri_solve_and_chol_solve_broadcast_as_jax(transpose):
    """L (3, 1, k, k) against B (2, k, n): both batch shapes broadcast to
    (3, 2)."""
    rng = np.random.default_rng(1)
    L = np.linalg.cholesky(_spd(rng, (3, 1), 20)).astype(f32)
    B = rng.standard_normal((2, 20, 7)).astype(f32)
    got = tgm.tri_solve(_t(L), _t(B), transpose=transpose)
    assert got.shape == (3, 2, 20, 7)
    _close(got, jgm.tri_solve(_j(L), _j(B), transpose=transpose), atol=1e-5)
    _close(tgm.chol_solve(_t(L), _t(B)), jgm.chol_solve(_j(L), _j(B)), atol=1e-5)


def test_mvn_log_prob_and_sample_match_jax():
    rng = np.random.default_rng(2)
    k = 12
    L = np.linalg.cholesky(_spd(rng, (2, 3), k)).astype(f32)
    mu = rng.standard_normal((2, 3, k)).astype(f32)
    x = rng.standard_normal((2, 3, k)).astype(f32)
    _close(tgm.mvn_log_prob(_t(x), _t(mu), _t(L)), jgm.mvn_log_prob(_j(x), _j(mu), _j(L)))
    key = jax.random.key(3)
    want = jgm.mvn_sample(key, _j(mu), _j(L), sample_shape=(4,))
    eps = jax.random.normal(key, (4, 2, 3, k), jnp.float32)  # mvn_sample's own draw
    got = tgm.mvn_sample(_t(mu), _t(L), _t(eps))
    assert got.shape == (4, 2, 3, k)
    _close(got, want)


@pytest.mark.parametrize("k,batch", [(8, (2, 3)), (512, (1,))])
def test_mvn_kl_by_solves_matches_jax(k, batch):
    """Without L_p's inverse both sides solve against L_p (no split at
    k = 512 then), and agree with the inverse branch."""
    rng = np.random.default_rng(k + 1)
    Lp = np.linalg.cholesky(_spd(rng, batch, k)).astype(f32)
    Lq = np.linalg.cholesky(_spd(rng, batch, k, ridge=0.3)).astype(f32)
    mq = rng.standard_normal((*batch, k)).astype(f32)
    mp = rng.standard_normal((*batch, k)).astype(f32)
    got = tgm.mvn_kl(_t(mq), _t(Lq), _t(mp), _t(Lp))
    _close(got, jgm.mvn_kl(_j(mq), _j(Lq), _j(mp), _j(Lp)), rtol=2e-5)
    inv = tgm.mvn_kl(_t(mq), _t(Lq), _t(mp), _t(Lp), Lp_inv=_t(np.linalg.inv(Lp).astype(f32)))
    _close(got, inv.numpy(), rtol=2e-5)


def _chain(rng, sizes, H=2, O=3):
    S = sum(sizes)
    L = np.linalg.cholesky(_spd(rng, (H, O), S)).astype(f32)
    Li = np.linalg.inv(L).astype(f32)
    u_means = [rng.standard_normal((O, m, 1)).astype(f32) for m in sizes]
    u_trils = [np.tril(rng.standard_normal((O, m, m)) * 0.3).astype(f32) for m in sizes]
    return L, Li, u_means, u_trils


@pytest.mark.parametrize("sizes", [(8, 8, 8), (6, 10, 4), (9,)])
@pytest.mark.parametrize("with_inv", [True, False])
def test_ar_joint_posterior_matches_jax(sizes, with_inv):
    rng = np.random.default_rng(sum(sizes) + with_inv)
    L, Li, um, ut = _chain(rng, sizes)
    got = tgm.ar_joint_posterior(_t(L), [*map(_t, um)], [*map(_t, ut)],
                                 L_inv=_t(Li) if with_inv else None)
    want = jgm.ar_joint_posterior(_j(L), [*map(_j, um)], [*map(_j, ut)],
                                  L_inv=_j(Li) if with_inv else None)
    _close(got.mean, want.mean, atol=1e-5)
    _close(got.LS, want.LS, atol=1e-5)


@pytest.mark.parametrize("sizes", [(8, 8, 8), (6, 10, 4), (9,)])
def test_ar_joint_posterior_fast_matches_jax(sizes):
    """Equal blocks take the block-LDL build; one task is its own
    posterior; unequal blocks take the fold."""
    rng = np.random.default_rng(sum(sizes) + 7)
    L, Li, um, ut = _chain(rng, sizes)
    got = tgm.ar_joint_posterior_fast(_t(L), _t(Li), [*map(_t, um)], [*map(_t, ut)])
    want = jcond.ar_joint_posterior_fast(_j(L), _j(Li), [*map(_j, um)], [*map(_j, ut)])
    _close(got.mean, want.mean, atol=1e-5)
    _close(got.LS, want.LS, atol=1e-5)
    fold = tgm.ar_joint_posterior(_t(L), [*map(_t, um)], [*map(_t, ut)], L_inv=_t(Li))
    _close(got.LS, fold.LS.numpy(), atol=1e-5)


@pytest.mark.parametrize("sizes", [(8, 8, 8), (128, 128, 128, 128)])
@pytest.mark.parametrize("with_inv", [True, False])
def test_whitened_marginal_diag_matches_jax(sizes, with_inv):
    """Both branches; at S = 512 the L^-1 branch splits at 256 (plain
    slices here, tri3_blocks there)."""
    rng = np.random.default_rng(len(sizes) + with_inv)
    H, O, B = (2, 3, 5) if len(sizes) == 3 else (1, 1, 6)
    L, Li, um, ut = _chain(rng, sizes, H, O)
    S = sum(sizes)
    post = jgm.ar_joint_posterior(_j(L), [*map(_j, um)], [*map(_j, ut)], L_inv=_j(Li))
    Kzx = (rng.random((H, O, S, B)) * 0.5).astype(f32)
    kxx = (np.exp(rng.standard_normal((H, 1, 1))) + 2.0).astype(f32)
    Li_arg = (_t(Li), _j(Li)) if with_inv else (None, None)
    got = tgm.whitened_marginal_diag(_t(L), _t(post.mean), _t(post.LS), _t(Kzx), _t(kxx),
                                     L_inv=Li_arg[0])
    want = jgm.whitened_marginal_diag(_j(L), post.mean, post.LS, _j(Kzx), _j(kxx),
                                      L_inv=Li_arg[1])
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-4, atol=1e-5)
