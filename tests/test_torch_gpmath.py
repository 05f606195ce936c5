"""vargp_tpu_torch.gpmath, the plain version of K3 and the factorisation's
backward rule against the JAX package, on the CPU, with the same numpy
inputs on both sides.

Tolerances: both sides compute in f32 on the CPU (the JAX package's
"high" products are full f32 there), so they differ only by summation
order and by the Cholesky's column order (right-looking loop against
LAPACK's blocked one).  The bounds are f32 rounding (1e-6 .. 1e-5
relative) grown by the conditioning of the factor for the inverses.  The
backward rules are the same f32 products on the same (L, L^-1) in another
association, on full random cotangents that each pass through two
products with L^-1 (S = 192 to 512 terms a sum): 5e-5 of the result's
largest magnitude (the largest error seen is 1.2e-5 of it).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vargp_tpu import gpmath as jgm
from vargp_tpu.gpmath import conditional as jcond
from vargp_tpu.ops import dispatch as jdispatch
from vargp_tpu_torch import gpmath as tgm
from vargp_tpu_torch.gpmath import linalg as tlinalg
from vargp_tpu_torch.ops import dispatch as tdispatch
from vargp_tpu_torch.ops.cuda.diag_chol import diag_chol, diag_chol_plain

f32 = np.float32


def _t(a):
    return torch.tensor(np.asarray(a))


def _spd(rng, batch, S, ridge=0.5):
    A = rng.standard_normal((*batch, S, S)).astype(f32)
    return A @ np.swapaxes(A, -1, -2) / S + ridge * np.eye(S, dtype=f32)


# --------------------------------------------------------------------------
# tril
# --------------------------------------------------------------------------


@pytest.mark.parametrize("batch,m", [((), 1), ((3,), 5), ((2, 3), 7)])
def test_vec2tril_matches_jax(batch, m):
    rng = np.random.default_rng(m)
    vec = rng.standard_normal((*batch, m * (m + 1) // 2)).astype(f32) * 2.0
    got = tgm.vec2tril(_t(vec), m).numpy()
    np.testing.assert_allclose(got, np.asarray(jgm.vec2tril(jnp.asarray(vec), m)), rtol=1e-6, atol=1e-7)
    # row-major packing round-trips through mat2trilvec (off-diagonal exact)
    packed = tgm.mat2trilvec(_t(got)).numpy()
    np.testing.assert_array_equal(packed, np.asarray(jgm.mat2trilvec(jnp.asarray(got))))


def test_tril_sizes_and_errors():
    assert [tgm.tril_size(m) for m in range(5)] == [jgm.tril_size(m) for m in range(5)]
    assert tgm.tril_dim(21) == 6
    with pytest.raises(ValueError):
        tgm.tril_dim(20)
    with pytest.raises(ValueError):
        tgm.vec2tril(torch.zeros(2, 10), 5)


# --------------------------------------------------------------------------
# K3 plain version and the blocked factorisation
# --------------------------------------------------------------------------


def test_diag_chol_plain_matches_jnp_cholesky():
    rng = np.random.default_rng(7)
    K = _spd(rng, (4,), 128)
    got = diag_chol(_t(K)).numpy()  # CPU tensor: the plain version
    np.testing.assert_allclose(got, np.asarray(jnp.linalg.cholesky(jnp.asarray(K))), atol=2e-5)
    assert np.all(np.triu(got, 1) == 0.0)


def test_diag_chol_plain_identity_padding_is_exact():
    rng = np.random.default_rng(8)
    S = 100
    K = _spd(rng, (3,), S)
    Lp = tlinalg._diag_chol(_t(K)).numpy()  # pads to 128, slices back
    np.testing.assert_allclose(Lp, np.linalg.cholesky(K), atol=2e-5)
    padded = tlinalg.pad_identity_tail(_t(K), 128)
    full = diag_chol_plain(padded).numpy()
    np.testing.assert_array_equal(full[:, S:, S:], np.broadcast_to(np.eye(28, dtype=f32), (3, 28, 28)))
    assert np.max(np.abs(full[:, S:, :S])) == 0.0


def test_diag_chol_plain_nan_on_non_positive_pivot():
    """A non-positive pivot gives NaN from that column on, with the factor
    of the leading block intact, as the TPU kernel does (no clamp, no
    swallowed error).  jnp.linalg.cholesky reports the failure as NaN too."""
    K = np.eye(128, dtype=f32)[None].repeat(2, 0)
    K[1, :6, :6] = _spd(np.random.default_rng(3), (), 6)
    K[1, 5, 5] = -1.0
    L = diag_chol_plain(_t(K)).numpy()
    np.testing.assert_array_equal(L[0], np.eye(128, dtype=f32))
    assert np.isnan(L[1, 5, 5]) and np.all(np.isnan(L[1, 5:, 5]))
    assert np.all(np.isfinite(L[1, :5, :5]))
    np.testing.assert_allclose(L[1, :5, :5], np.linalg.cholesky(K[1, :5, :5]), atol=1e-6)
    assert np.all(L[1][np.triu_indices(128, 1)] == 0.0)
    assert np.isnan(np.asarray(jnp.linalg.cholesky(jnp.asarray(K[1])))).any()


def test_pick_block_matches_pallas_backend(monkeypatch):
    """The port's split rule is the JAX package's with the K3 bound
    (blocks <= 128), i.e. its rule on the Pallas backend, at every S."""
    monkeypatch.setattr(jdispatch, "_BACKEND", "pallas")
    for S in range(1, 1200):
        assert tdispatch._pick_block(S) == jdispatch._pick_block(S), S


@pytest.mark.parametrize("S", [60, 150, 192, 300, 257])
def test_chol_and_inv_matches_jax(S):
    """Every branch of the split: S <= 128 (K3 + Newton), 128 < S <= 160
    (library factor + blocked inverse), blocked 2 x 96 and 3 x 100 (K3 on
    identity-padded blocks), and S = 257 with no friendly divisor."""
    rng = np.random.default_rng(S)
    K = _spd(rng, (2, 3), S)
    if S in (192, 300):  # the blocked split, with the JAX package's block
        assert tdispatch._pick_block(S) == jdispatch._pick_block(S) == S // (S // 96)
    L, Li = tdispatch.chol_and_inv(_t(K))
    jL, jLi = jdispatch.chol_and_inv(jnp.asarray(K))
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), atol=5e-5)
    np.testing.assert_allclose(Li.numpy(), np.asarray(jLi), atol=5e-4)
    eye = np.broadcast_to(np.eye(S, dtype=f32), K.shape)
    np.testing.assert_allclose((Li @ L).numpy(), eye, atol=5e-5)


@pytest.mark.parametrize("S,d", [(300, 100), (250, 125)])
def test_blocked_factorisation_hands_k3_views(monkeypatch, S, d):
    """``chol_and_inv_blocked`` gives K3 each diagonal block as the view it
    is (A's 100-wide blocks, B's 125-wide ones), with no pad, copy or
    slice around the call; the result still matches the JAX package's."""
    seen = []

    def spy(A):
        seen.append((tuple(A.shape[-2:]), A.is_contiguous(), A.stride(-2)))
        return diag_chol(A)

    monkeypatch.setattr(tlinalg, "diag_chol", spy)
    K = _spd(np.random.default_rng(S), (2,), S)
    L, Li = tlinalg.chol_and_inv_blocked(_t(K), d)
    T = S // d  # the last trailing matrix is the block itself
    assert seen == [((d, d), t == T - 1, S - t * d) for t in range(T)]
    jL, jLi = jdispatch.chol_and_inv(jnp.asarray(K))
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), atol=5e-5)
    np.testing.assert_allclose(Li.numpy(), np.asarray(jLi), atol=5e-4)


def test_add_jitter_pad_and_tri_inv_match_jax():
    rng = np.random.default_rng(1)
    K = _spd(rng, (2,), 200)
    np.testing.assert_array_equal(
        tgm.add_jitter(_t(K)).numpy(), np.asarray(jgm.add_jitter(jnp.asarray(K)))
    )
    np.testing.assert_array_equal(
        tlinalg.pad_identity_tail(_t(K[..., :50, :50]), 64).numpy(),
        np.asarray(jgm.linalg.pad_identity_tail(jnp.asarray(K[..., :50, :50]), 64)),
    )
    L = np.linalg.cholesky(K).astype(f32)
    np.testing.assert_allclose(
        tgm.tri_inv(_t(L)).numpy(), np.asarray(jgm.tri_inv(jnp.asarray(L))), atol=1e-4
    )


@pytest.mark.parametrize("S", [192, 512])
def test_chol_and_inv_backward_matches_jax_rule(S):
    """S = 192 takes the dense Murray rule, S = 512 the triangle-skip rule
    split at tri_half_split(512) = 256, on both sides; the JAX rule gets
    the port's own (L, L^-1) as residuals."""
    rng = np.random.default_rng(S + 1)
    K = _t(_spd(rng, (2, 3), S)).requires_grad_()
    GL = rng.standard_normal((2, 3, S, S)).astype(f32)
    Gi = rng.standard_normal((2, 3, S, S)).astype(f32)
    L, Li = tdispatch.chol_and_inv(K)
    got, = torch.autograd.grad((L, Li), K, (_t(GL), _t(Gi)))
    assert jdispatch._tri_bwd_split(S) == tgm.linalg.tri_half_split(S) == (256 if S == 512 else None)
    want, = jdispatch._chol_and_inv_bwd(
        None, (jnp.asarray(L.detach().numpy()), jnp.asarray(Li.detach().numpy())),
        (jnp.asarray(GL), jnp.asarray(Gi)))
    scale = float(np.max(np.abs(np.asarray(want))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=5e-5 * scale)
    if S == 512:  # the split rule mirrors its off-diagonal block, and agrees with the dense rule
        Kb = got.numpy()
        np.testing.assert_array_equal(Kb[..., :256, 256:], np.swapaxes(Kb[..., 256:, :256], -1, -2))
        dense = tdispatch._chol_bwd_dense(L.detach(), Li.detach(), _t(GL), _t(Gi))
        np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0, atol=5e-5 * scale)


def test_diag_blocks_view_matches_jax_and_its_gradient():
    from vargp_tpu_torch.gpmath import conditional as tcond

    rng = np.random.default_rng(5)
    T, M = 3, 5
    A = rng.standard_normal((2, T * M, T * M)).astype(f32)
    g = rng.standard_normal((2, T, M, M)).astype(f32)
    At = _t(A).requires_grad_()
    got = tcond._diag_blocks(At, T, M)
    want, vjp = jax.vjp(lambda a: jcond._diag_blocks(a, T, M), jnp.asarray(A))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    got.backward(_t(g))
    np.testing.assert_array_equal(At.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


# --------------------------------------------------------------------------
# mvn
# --------------------------------------------------------------------------


@pytest.mark.parametrize("k,batch", [(8, (2, 3)), (512, (1,))])
def test_mvn_kl_matches_jax(k, batch):
    """k = 512 takes the block-triangular split on both sides."""
    rng = np.random.default_rng(k)
    Lp = np.linalg.cholesky(_spd(rng, batch, k)).astype(f32)
    Lq = np.linalg.cholesky(_spd(rng, batch, k, ridge=0.3)).astype(f32)
    Lp_inv = np.linalg.inv(Lp).astype(f32)
    mq = rng.standard_normal((*batch, k)).astype(f32)
    mp = rng.standard_normal((*batch, k)).astype(f32)
    got = tgm.mvn_kl(_t(mq), _t(Lq), _t(mp), _t(Lp), Lp_inv=_t(Lp_inv)).numpy()
    want = np.asarray(jgm.mvn_kl(*map(jnp.asarray, (mq, Lq, mp, Lp)), Lp_inv=jnp.asarray(Lp_inv)))
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_diag_normal_kl_matches_jax():
    rng = np.random.default_rng(2)
    a = [rng.standard_normal(9).astype(f32) for _ in range(4)]
    np.testing.assert_allclose(
        tgm.diag_normal_kl(*map(_t, a)).numpy(),
        np.asarray(jgm.mvn.diag_normal_kl(*map(jnp.asarray, a))),
        rtol=1e-6, atol=1e-6,
    )


# --------------------------------------------------------------------------
# factored AR posterior and marginal
# --------------------------------------------------------------------------


@pytest.mark.parametrize("T", [1, 3])
def test_factored_posterior_and_marginal_match_jax(T):
    rng = np.random.default_rng(10 + T)
    H, O, M, B = 2, 3, 8, 5
    S = T * M
    L = np.linalg.cholesky(_spd(rng, (H, O), S)).astype(f32)
    Li = np.linalg.inv(L).astype(f32)
    u_means = [rng.standard_normal((O, M, 1)).astype(f32) for _ in range(T)]
    u_trils = [np.tril(rng.standard_normal((O, M, M))).astype(f32) for _ in range(T)]
    Kzx = rng.random((H, O, S, B)).astype(f32)
    kxx = np.exp(rng.standard_normal((H, 1, 1))).astype(f32) + 1.0

    tp = tgm.ar_joint_posterior_factored(_t(L), _t(Li), [*map(_t, u_means)], [*map(_t, u_trils)])
    if T == 1:
        # the JAX package takes its materialised form at T = 1: compare the
        # marginal against that form and the factors against their definition
        jp = jcond.ar_joint_posterior(jnp.asarray(L), [*map(jnp.asarray, u_means)],
                                      [*map(jnp.asarray, u_trils)], L_inv=jnp.asarray(Li))
        want = jgm.whitened_marginal_diag(jnp.asarray(L), jp.mean, jp.LS, jnp.asarray(Kzx),
                                          jnp.asarray(kxx), L_inv=jnp.asarray(Li))
        np.testing.assert_allclose(tp.w.numpy()[..., 0, :, :], Li @ u_trils[0], rtol=1e-5, atol=1e-5)
    else:
        jp = jgm.ar_joint_posterior_factored(jnp.asarray(L), jnp.asarray(Li),
                                             [*map(jnp.asarray, u_means)], [*map(jnp.asarray, u_trils)])
        np.testing.assert_allclose(tp.v.numpy(), np.asarray(jp.v), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tp.w.numpy(), np.asarray(jp.w), rtol=1e-5, atol=1e-5)
        want = jgm.whitened_marginal_diag_factored(jnp.asarray(Li), jp.v, jp.w,
                                                   jnp.asarray(Kzx), jnp.asarray(kxx))
    got = tgm.whitened_marginal_diag_factored(_t(Li), tp.v, tp.w, _t(Kzx), _t(kxx))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
