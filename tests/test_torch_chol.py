"""The plain versions of K7 (batched Cholesky), K6 (fused Cholesky and
triangular inverse), K3 (diagonal-block Cholesky) and K8 (chunked
128-block Cholesky), and the backward rules around K7 and K6, against the
JAX package on the CPU: K7, K6 and K3 against their Pallas kernels run in
interpret mode, K8 against ``jnp.linalg.cholesky`` (the JAX test's own
reference: the Pallas K8 is slow in interpret mode).  K3's wrapper takes
views; its checks of shape and strides run on every device.

Tolerances: every side factors in f32 on the CPU; the kernels and the
plain versions differ from the interpreted TPU kernels by the column
order of the panel steps and the diagonal blocks' products with their
inverses, so a factor of a well-conditioned matrix (eigenvalues >= 0.5)
agrees to 2e-5 absolute (entries O(1)) and its inverse to 5e-5.  The
backward rules are f32 products and solves on the same factor: each
gradient is held to 1e-4 of its largest magnitude on its symmetric part
(the JAX rules return the symmetric gradient too; the test compares
symmetric parts as tests/test_pallas.py does).

The kernels compute their products in 3xTF32 on the tensor cores; a test
here runs the plain panel algorithm through an emulation of that
arithmetic (helpers of tests/_torch_cases.py, not in the package) and
holds the factor to the smoke test's tolerance, 1e-4 absolute, of a float64 factor; another
does the same for K3's 32-column chunks.

K3 reads the lower triangle, the Pallas K3 rows as columns (the upper
triangle): on an input that is not bitwise symmetric they differ by the
asymmetry (f32 rounding of a product, ~1e-7 of the entries) carried
through a well-conditioned factor, within ATOL_L.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vargp_tpu import gpmath as jgm
from vargp_tpu.ops.pallas.chol import cholesky_pallas
from vargp_tpu.gpmath.linalg import pad_identity_tail as jpad_identity_tail
from vargp_tpu.ops.pallas.chol_inv import _chol_inv_call
from vargp_tpu.ops.pallas.chol_panel import diag_chol_pallas_t
from vargp_tpu_torch.ops import dispatch as tdispatch
from vargp_tpu_torch.ops.cuda.chol import (blocked_plain, cholesky, cholesky_plain, cluster_size,
                                            tri_inv_plain)
from vargp_tpu_torch.ops.cuda.chol_inv import chol_inv, chol_inv_plain
from vargp_tpu_torch.gpmath import linalg as tlinalg
from vargp_tpu_torch.ops.cuda.diag_chol import diag_chol, diag_chol_chunked, diag_chol_plain
from vargp_tpu_torch.utils import tracing
from tests._torch_cases import _mm3, _tf32

f32 = np.float32
# one intra-op thread per test process, as tests/_torch_cases.py sets it
torch.set_num_threads(1)
ATOL_L = 2e-5
ATOL_INV = 5e-5
TOL_GRAD = 1e-4
TOL_CHOL = 1e-4  # chip_smoke.py's tolerance of K6 and K7 against their plain versions


def _t(a):
    return torch.tensor(np.asarray(a))


def _spd(rng, batch, S, ridge=0.5):
    A = rng.standard_normal((*batch, S, S)).astype(f32)
    return (A @ np.swapaxes(A, -1, -2) / f32(S) + f32(ridge) * np.eye(S, dtype=f32)).astype(f32)


def _sym(a):
    a = np.asarray(a)
    return 0.5 * (a + np.swapaxes(a, -1, -2))


@pytest.mark.parametrize("S", [16, 128, 200])
def test_k7_plain_matches_pallas_interpret(S):
    K = _spd(np.random.default_rng(S), (3,), S)
    want = np.asarray(cholesky_pallas(jnp.asarray(K), interpret=True))
    got = cholesky(_t(K)).numpy()  # CPU tensor: the plain version
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_L)
    assert np.all(np.triu(got, 1) == 0.0)


@pytest.mark.parametrize("S", [16, 128, 300])
def test_k6_plain_matches_pallas_interpret(S):
    K = _spd(np.random.default_rng(S + 1), (3,), S)
    jL, jX = _chol_inv_call(jnp.asarray(K), interpret=True)
    L, X = chol_inv(_t(K))  # CPU tensors: the plain version
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), rtol=0, atol=ATOL_L)
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=0, atol=ATOL_INV)
    np.testing.assert_allclose((X @ L).numpy(), np.broadcast_to(np.eye(S, dtype=f32), K.shape),
                               atol=ATOL_INV)
    np.testing.assert_array_equal(L.numpy(), cholesky_plain(_t(K)).numpy())


@pytest.mark.parametrize("G", [5, 30])
def test_k8_plain_matches_jnp_cholesky(G):
    K = _spd(np.random.default_rng(G), (G,), 128)
    got = diag_chol_chunked(_t(K)).numpy()  # CPU tensor: the plain version
    np.testing.assert_allclose(got, np.asarray(jnp.linalg.cholesky(jnp.asarray(K))), atol=ATOL_L)
    np.testing.assert_array_equal(got, diag_chol_plain(_t(K)).numpy())


@pytest.mark.parametrize("S", [77, 256, 300])
def test_k7_and_k6_plain_read_only_the_lower_triangle(S):
    """Ragged (77, 300) and whole (256) panels; what lies above the
    diagonal never enters the factor or its inverse."""
    K = _spd(np.random.default_rng(S + 2), (2,), S)
    junk = K + np.triu(np.full_like(K, 7.0), 1)
    np.testing.assert_array_equal(cholesky_plain(_t(junk)).numpy(), cholesky_plain(_t(K)).numpy())
    for a, b in zip(chol_inv_plain(_t(junk)), chol_inv_plain(_t(K))):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_allclose(cholesky_plain(_t(K)).numpy(), np.linalg.cholesky(K), atol=ATOL_L)


def test_tri_inv_plain_matches_jax_tri_inv():
    K = _spd(np.random.default_rng(4), (2, 3), 128)
    L = np.linalg.cholesky(K).astype(f32)
    np.testing.assert_allclose(tri_inv_plain(_t(L)).numpy(), np.asarray(jgm.tri_inv(jnp.asarray(L))),
                               atol=ATOL_INV)


@pytest.mark.parametrize("S,bad", [(300, 150), (128, 5)])
def test_k7_k6_plain_nan_on_non_positive_pivot(S, bad):
    """A non-positive pivot gives NaN from that column on, the factor (and
    inverse) of the leading block intact, an identity matrix's factor
    exact: no clamp and no swallowed error, as the TPU kernels."""
    K = np.eye(S, dtype=f32)[None].repeat(2, 0)
    K[1, bad, bad] = -1.0
    L = cholesky_plain(_t(K)).numpy()
    L2, X = (a.numpy() for a in chol_inv_plain(_t(K)))
    for F in (L, L2, X):
        np.testing.assert_array_equal(F[0], np.eye(S, dtype=f32))
        assert np.isnan(F[1, bad, bad]) and np.all(np.isnan(F[1, bad:, bad]))
        np.testing.assert_array_equal(F[1, :bad, :bad], np.eye(bad, dtype=f32))
    K = np.eye(128, dtype=f32)[None]
    K[0, 5, 5] = 0.0
    assert np.isnan(diag_chol_chunked(_t(K)).numpy()[0, 5, 5])


@pytest.mark.parametrize("S", [40, 200])
def test_cholesky_gradient_matches_jax(S):
    """``batched_cholesky``'s rule against jax.grad through
    jnp.linalg.cholesky, which symmetrises its input."""
    rng = np.random.default_rng(S + 3)
    K = _spd(rng, (2,), S)
    W = rng.standard_normal((2, S, S)).astype(f32)
    want = jax.grad(lambda k: jnp.sum(jnp.linalg.cholesky(k) * W))(jnp.asarray(K))
    Kt = _t(K).requires_grad_()
    L = tdispatch.batched_cholesky(Kt)
    (got,) = torch.autograd.grad(torch.sum(L * _t(W)), Kt)
    np.testing.assert_allclose(L.detach().numpy(), np.linalg.cholesky(K), atol=ATOL_L)
    scale = float(np.max(np.abs(_sym(want))))
    np.testing.assert_allclose(_sym(got.numpy()), _sym(want), rtol=0, atol=TOL_GRAD * scale)
    np.testing.assert_allclose(got.numpy(), _sym(got.numpy()), rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("with_inv", [True, False])
def test_chol_and_inv_fused_gradient_matches_jax_composition(with_inv):
    """``chol_and_inv_fused`` (K6's plain version here) against
    jnp.linalg.cholesky and the JAX package's tri_inv; without the
    inverse's cotangent the rule takes ``Ginv is None``."""
    rng = np.random.default_rng(8)
    S = 40
    K = _spd(rng, (2,), S)
    wL = rng.standard_normal((2, S, S)).astype(f32)
    wI = rng.standard_normal((2, S, S)).astype(f32) if with_inv else np.zeros((2, S, S), f32)

    def f_ref(k):
        L = jnp.linalg.cholesky(k)
        return jnp.sum(L * wL) + jnp.sum(jgm.tri_inv(L) * wI)

    want = jax.grad(f_ref)(jnp.asarray(K))
    Kt = _t(K).requires_grad_()
    L, X = tdispatch.chol_and_inv_fused(Kt)
    out = torch.sum(L * _t(wL)) + (torch.sum(X * _t(wI)) if with_inv else 0.0)
    (got,) = torch.autograd.grad(out, Kt)
    scale = float(np.max(np.abs(_sym(want))))
    np.testing.assert_allclose(_sym(got.numpy()), _sym(want), rtol=0, atol=TOL_GRAD * scale)


def test_cholinv_knob_routes_the_forward_and_raises_on_unknown(monkeypatch):
    """VARGP_TPU_CHOLINV is read at each call: ``pallas`` takes K6 for the
    whole batch (its plain version here), ``xla`` the blocked route, and
    any other value raises."""
    K = _t(_spd(np.random.default_rng(9), (2,), 300))
    base = tdispatch.chol_and_inv(K)
    monkeypatch.setenv("VARGP_TPU_CHOLINV", "pallas")
    fused = tdispatch.chol_and_inv(K)
    for a, b, c in zip(fused, chol_inv_plain(K), base):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=ATOL_INV)
    monkeypatch.setenv("VARGP_TPU_CHOLINV", "xla")
    np.testing.assert_array_equal(tdispatch.chol_and_inv(K)[0].numpy(), base[0].numpy())
    monkeypatch.setenv("VARGP_TPU_CHOLINV", "cusolver")
    with pytest.raises(ValueError, match="VARGP_TPU_CHOLINV"):
        tdispatch.chol_and_inv(K)


def test_wrappers_reject_unknown_devices():
    K = torch.eye(8).to("meta")
    for fn in (cholesky, chol_inv, diag_chol_chunked):
        with pytest.raises(ValueError, match="no kernel for device"):
            fn(K)
    assert not {"vargp_chol", "vargp_chol_inv", "vargp_diag_chol_chunked"} & set(+tracing.LAUNCHES)


def _mm1(a, b):
    return torch.matmul(_tf32(a), _tf32(b))


def test_tf32_rounding_is_round_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 3.0e-8], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, -(1.0 + 2.0 ** -10), 1.0,
                         float(np.float32(3.0e-8))], dtype=torch.float64)
    got = _tf32(x).double()
    np.testing.assert_array_equal(got[:5].numpy(), want[:5].numpy())
    assert abs(float(got[5]) - 3.0e-8) <= 3.0e-8 * 2.0 ** -11


def test_3xtf32_products_keep_the_factor_at_f32_accuracy():
    """blocked_plain's products through the 3-term split at B's S = 1000
    (two matrices made as chip_smoke.py's spd_blocks): the factor within
    TOL_CHOL of the float64 factor and no further from it than twice the
    f32 plain factor; one 3-term product within f32 rounding of the
    float64 product.  One TF32 product per term is printed for contrast."""
    rng = np.random.default_rng(10)
    K = _t(_spd(rng, (2,), 1000))
    L64 = torch.linalg.cholesky(K.double())
    err = lambda L: float((L.double() - L64).abs().max())
    e32, e3, e1 = (err(blocked_plain(K, mm)[0]) for mm in (torch.matmul, _mm3, _mm1))
    print(f"max |L - L_f64| at (2, 1000, 1000): f32 products {e32:.3e}, 3xTF32 {e3:.3e}, "
          f"1xTF32 {e1:.3e}")
    assert e3 <= TOL_CHOL and e3 <= 2 * e32
    a = torch.tensor(rng.standard_normal((128, 128)), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal((128, 128)), dtype=torch.float32)
    exact = a.double() @ b.double()
    rounding = 128 * 2.0 ** -24 * (a.abs().double() @ b.abs().double())  # k u sum |a||b|
    assert bool(torch.all((_mm3(a, b).double() - exact).abs() <= rounding))
    assert not bool(torch.all((_mm1(a, b).double() - exact).abs() <= rounding))


@pytest.mark.parametrize("G,C", [(1, 8), (16, 8), (17, 4), (30, 4), (33, 4), (34, 2), (66, 2),
                                 (67, 1), (200, 1)])
def test_cluster_size_on_132_sms(G, C):
    """One cluster per matrix: the largest power of two <= min(8, 132 // G)."""
    assert cluster_size(G, 132) == C


# --------------------------------------------------------------------------
# K3: the diagonal-block Cholesky, read in place
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _k3_cases():
    """K3's inputs against the Pallas kernel, each with what the JAX package
    makes of it, from one interpret-mode call (~8 s on a CPU):

    schur: the Schur complement of ``chol_and_inv_blocked``'s second block
      at S = 256, its upper triangle's products summed in the reverse
      order (as a GPU product's tiles may sum them): not bitwise symmetric;
    h100, h125: ragged blocks as strided views of wider matrices (A's and
      B's block widths), against the JAX caller's identity pad, the kernel
      and the slice (vargp_tpu/gpmath/linalg.py:152-156)."""
    rng = np.random.default_rng(21)
    K = _t(_spd(rng, (1,), 256))
    Dinv = tlinalg._tri_inv_newton(tlinalg._diag_chol(K[..., :128, :128]))
    Lcol = tlinalg.mmt(K[..., 128:, :128], Dinv)
    lower, upper = tlinalg.mmt(Lcol, Lcol), tlinalg.mmt(Lcol.flip(-1), Lcol.flip(-1))
    schur = K[..., 128:, 128:] - (torch.tril(lower) + torch.triu(upper, 1))
    v100 = _t(_spd(rng, (2,), 300))[:, 50:150, 50:150]
    v125 = _t(_spd(rng, (2,), 250))[:, 125:, 125:]
    jin = [schur.numpy()] + [np.asarray(jpad_identity_tail(jnp.asarray(v.numpy()), 128))
                             for v in (v100, v125)]
    jout = np.asarray(diag_chol_pallas_t(jnp.asarray(np.concatenate(jin)), interpret=True))
    return {"schur": (schur, jout[:1]), "h100": (v100, jout[1:3, :100, :100]),
            "h125": (v125, jout[3:, :125, :125])}


@pytest.mark.parametrize("case", ["schur", "h100", "h125"])
def test_k3_matches_pallas_interpret(case):
    A, want = _k3_cases()[case]
    if case == "schur":
        asym = float((A - A.transpose(-1, -2)).abs().max())
        print(f"Schur complement: max |A - A^T| = {asym:.3e}")
        assert asym > 0.0
    else:
        assert not A.is_contiguous()
    got = diag_chol(A).numpy()  # CPU tensor: the plain version
    np.testing.assert_allclose(got, want, atol=ATOL_L)
    assert np.all(np.triu(got, 1) == 0.0)


def _chunked_factor(K, mm):
    """K3's arithmetic on the CPU: per 32-column chunk the 32 x 32 block's
    column loop, the rows below solved against it, then the trailing
    update L21 L21^T through ``mm``."""
    A, n = K.clone(), K.shape[-1]
    L = torch.zeros_like(A)
    for c0 in range(0, n, 32):
        t0 = c0 + 32
        L11 = diag_chol_plain(A[..., c0:t0, c0:t0])
        L[..., c0:t0, c0:t0] = L11
        if t0 == n:
            break
        X = torch.linalg.solve_triangular(L11, A[..., t0:, c0:t0].transpose(-1, -2),
                                          upper=False).transpose(-1, -2)
        L[..., t0:, c0:t0] = X
        A[..., t0:, t0:] = A[..., t0:, t0:] - mm(X, X.transpose(-1, -2))
    return L


def test_k3_chunked_3xtf32_arithmetic_keeps_f32_accuracy():
    """K3's 32-column chunks with the rank-32 updates in 3xTF32, at
    (2, 128, 128) made as chip_smoke.py's spd_blocks: within TOL_CHOL of the
    float64 factor and no further from it than twice the same chunks with
    f32 products; one TF32 product per update printed for contrast."""
    K = _t(_spd(np.random.default_rng(12), (2,), 128))
    L64 = torch.linalg.cholesky(K.double())
    err = lambda L: float((L.double() - L64).abs().max())
    e32, e3, e1 = (err(_chunked_factor(K, mm)) for mm in (torch.matmul, _mm3, _mm1))
    print(f"max |L - L_f64| at (2, 128, 128): f32 products {e32:.3e}, 3xTF32 {e3:.3e}, "
          f"1xTF32 {e1:.3e}; the plain column loop {err(diag_chol_plain(K)):.3e}")
    assert e3 <= TOL_CHOL and e3 <= 2 * e32


def test_k3_wrapper_checks_shapes_and_strides():
    """Bad blocks raise on every device; a strided view whose batch
    dimensions flatten to one stride gives exactly what its contiguous
    copy gives."""
    x = _t(_spd(np.random.default_rng(13), (4, 6), 16))
    for bad, msg in ((torch.eye(129)[None], "at most 128"), (x[..., :8, :9], "square"),
                     (x[0, :2].transpose(-1, -2), "last stride"), (x[:, :3], "flatten"),
                     (x.transpose(0, 1), "flatten")):
        with pytest.raises(ValueError, match=msg):
            diag_chol(bad)
    with pytest.raises(ValueError, match="no kernel for device"):
        diag_chol(x.to("meta"))
    for view in (x[:, :, 2:10, 2:10], x[2, 1:4, 3:, 3:], x[:, 2], x[1, 1].expand(3, 16, 16),
                 x[1:2, 3:4, :5, :5]):
        np.testing.assert_array_equal(diag_chol(view).numpy(), diag_chol(view.contiguous()).numpy())


@pytest.mark.parametrize("h", [1, 33, 100, 125])
def test_k3_cpu_block_equals_padded_factor_bitwise(h):
    """On the CPU K3 factors the h x h view itself: bitwise the leading
    block of the factor of the view padded with an identity tail to 128
    (the kernel's blockdiag(A, I)), whose tail comes back exact."""
    A = _t(_spd(np.random.default_rng(15), (2,), 300))[:, 40:40 + h, 40:40 + h]
    padded = diag_chol_plain(tlinalg.pad_identity_tail(A, 128))
    np.testing.assert_array_equal(diag_chol(A).numpy(), padded[:, :h, :h].numpy())
    tail = np.broadcast_to(np.eye(128 - h, dtype=np.float32), (2, 128 - h, 128 - h))
    np.testing.assert_array_equal(padded[:, h:, h:].numpy(), tail)
    assert not padded[:, h:, :h].any()


def test_k3_k8_launch_counters_stay_zero_on_the_cpu():
    K = _t(_spd(np.random.default_rng(14), (3,), 300))
    diag_chol(K[:, :100, :100]), diag_chol_chunked(K[:, :128, :128].contiguous())
    tdispatch.chol_and_inv(K)
    assert not {"vargp_diag_chol", "vargp_diag_chol_chunked"} & set(+tracing.LAUNCHES)
