"""The arithmetic of the tensor-core Gram tile that every Gram kernel runs
on the card (``vargp_tpu_torch/csrc/rbf_mma.cuh``: K1, K2, K4, K5),
emulated on the CPU: scale (not in K5's pre-scaled mode), accumulate each
row's norm in f32 from the scaled values, split each operand into big =
tf32(v) and small = tf32(v - big), take the 3-term product per 8-feature
step in the kernel's order (small*big, big*small, big*big), summed over
each 16-feature chunk into a zeroed f32 tile that is then added to the
accumulator, form d^2 (0 on a symmetric Gram's diagonal), clamp and exp.
The CUDA kernels themselves run only on the card (``chip_smoke.py``).

Tolerances.  At A's, B's and C's sizes the emulated Gram must lie within
twice the f32 plain version's max error against a float64 Gram: both carry
the f32 rounding of na + nb - 2 <a, b> (values ~2, ulp 2.4e-7), and the
3-term product adds ~2^-22 of each product, below that rounding.  The
mirrored pair walk must give a bitwise symmetric Gram, the same for any
tile size (K1's and K2's); the emulated full square must not be
symmetric, since (i, j) and (j, i) add the two cross terms in swapped
order, which is why the symmetric kernels compute each entry once and
mirror it.
"""

import math

import numpy as np
import pytest
import torch

from tests._torch_cases import _tf32
from vargp_tpu_torch.kernels.rbf import gram
from vargp_tpu_torch.ops import dispatch
from vargp_tpu_torch.ops.cuda.cross_gram import cross_gram_plain
from vargp_tpu_torch.ops.cuda.rbf_gram import rbf_gram_plain, same_storage
from vargp_tpu_torch.ops.cuda.sym_gram import sym_gram_plain

D = 784  # MNIST's features
F = 64  # the deep kernel's features


def _inputs(seed, S, B=0):
    """As chip_smoke.py's gram_inputs makes them, one hyper sample: z, x ~
    N(0, 1/D), log-lengthscales 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a.astype(np.float32))
    z = t(rng.standard_normal((S, D)) / math.sqrt(D))
    x = t(rng.standard_normal((max(B, 1), D)) / math.sqrt(D))
    log_ls = rng.standard_normal(D) * 0.1
    g2 = float(np.float32(np.exp(rng.standard_normal() * 0.2)))
    return z, x, t(np.exp(-log_ls)), t(np.exp(-2.0 * log_ls)), g2


def _mma3(a, b, chunk=16):
    """<a_i, b_j> as the tile accumulates it: per 8-feature step the
    small*big, big*small and big*big products added in turn into a zeroed
    f32 tile per chunk of features, each chunk's tile added to the sum."""
    ab, bb = _tf32(a), _tf32(b)
    asm, bsm = _tf32(a - ab), _tf32(b - bb)
    acc = torch.zeros(a.shape[0], b.shape[0])
    for k0 in range(0, a.shape[1], chunk):
        t = torch.zeros_like(acc)
        for k in range(k0, min(k0 + chunk, a.shape[1]), 8):
            k8 = slice(k, k + 8)
            t = t + asm[:, k8] @ bb[:, k8].T
            t = t + ab[:, k8] @ bsm[:, k8].T
            t = t + ab[:, k8] @ bb[:, k8].T
        acc = acc + t
    return acc


def _features(seed, S, B=1):
    """K5's inputs at C, as chip_smoke.py's dkl_features makes them: chain
    and batch features ~ N(0, 1/(2F)), gamma2 near 1."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a.astype(np.float32))
    sz = t(rng.standard_normal((S, F)) / math.sqrt(2 * F))
    sx = t(rng.standard_normal((B, F)) / math.sqrt(2 * F))
    return sz, sx, float(np.float32(np.exp(rng.standard_normal() * 0.2)))


def _tile(a, b, scale, g2, mode, diag=False):
    """The tile's Gram of rows a against rows b in one of its operand
    modes: "sym" (K1, K2) scales both by s; "cross" (K4) only b by w, and
    a's norm is <a, w a>; "prescaled" (K5) takes both as they are.  On a
    diagonal tile of a symmetric Gram (diag: a is b) the entries i == j
    take d^2 = 0, as the kernel's do."""
    if mode == "sym":
        va, vb = a * scale, b * scale
        na, nb = (va * va).sum(-1), (vb * vb).sum(-1)
    elif mode == "cross":
        va, vb = a, b * scale
        na, nb = (a * (a * scale)).sum(-1), (b * vb).sum(-1)
    else:
        va, vb = a, b
        na, nb = (va * va).sum(-1), (vb * vb).sum(-1)
    d2 = torch.clamp(na[:, None] + nb[None] - 2.0 * _mma3(va, vb), min=0.0)
    if diag:
        d2.fill_diagonal_(0.0)
    return g2 * torch.exp(-0.5 * d2)


def _gram64(a, b, w, g2):
    """The float64 Gram: g2 exp(-0.5 sum_d w_d (a_id - b_jd)^2)."""
    a, b, w = a.double(), b.double(), w.double()
    d2 = ((a * a) @ w)[:, None] + ((b * b) @ w)[None] - 2.0 * (a * w) @ b.T
    return g2 * torch.exp(-0.5 * d2.clamp(min=0.0))


def _errs(got, plain, ref):
    return float((got.double() - ref).abs().max()), float((plain.double() - ref).abs().max())


def test_k2_tile_within_twice_the_f32_error_at_b():
    """One (h, o) of K2 at B: 1000 x 1000 over 784 features."""
    z, _, s, w, g2 = _inputs(0, 1000)
    got = _tile(z, z, s, g2, "sym", diag=True)
    plain = sym_gram_plain(z[None], s[None], torch.tensor([g2]))[0, 0]
    e3, e32 = _errs(got, plain, _gram64(z, z, w, g2))
    print(f"K2 at (1000, 1000, 784): max |K - K_f64| 3xTF32 tile {e3:.3e}, f32 plain {e32:.3e}")
    assert e3 <= 2.0 * e32


def test_k4_tile_within_twice_the_f32_error_at_b():
    """One (h, o) of K4 at B: 1000 chain rows x 512 batch rows over 784."""
    z, x, _, w, g2 = _inputs(1, 1000, 512)
    got = _tile(z, x, w, g2, "cross")
    plain = cross_gram_plain(z[None], x, w[None], torch.tensor([g2]))[0, 0]
    e3, e32 = _errs(got, plain, _gram64(z, x, w, g2))
    print(f"K4 at (1000, 512, 784): max |K - K_f64| 3xTF32 tile {e3:.3e}, f32 plain {e32:.3e}")
    assert e3 <= 2.0 * e32


def _pair_walk(z, s, g2, tile, mode="sym"):
    """The symmetric kernels' store rule over their lower tile pairs
    (ti >= tj): an off-diagonal tile written at (ti, tj) and transposed at
    (tj, ti); a diagonal tile's computed lower triangle (i >= j) written to
    both halves.  Returns the Gram and how often each entry was written as
    computed and as a mirror."""
    S = z.shape[0]
    out = torch.full((S, S), float("nan"))
    direct = torch.zeros((S, S), dtype=torch.int32)
    mirror = torch.zeros((S, S), dtype=torch.int32)
    T = -(-S // tile)
    for ti in range(T):
        for tj in range(ti + 1):
            r, c = slice(ti * tile, (ti + 1) * tile), slice(tj * tile, (tj + 1) * tile)
            blk = _tile(z[r], z[c], s, g2, mode, diag=ti == tj)
            if ti == tj:
                lower = torch.ones_like(blk, dtype=torch.bool).tril()
                out[r, c] = torch.where(lower, blk, blk.T)
                direct[r, c] += lower.int()
                mirror[r, c] += (~lower).int()
            else:
                out[r, c] = blk
                direct[r, c] += 1
                out[c, r] = blk.T
                mirror[c, r] += 1
    return out, direct, mirror


@pytest.mark.parametrize("S,tile", [(1000, 128), (1000, 64), (520, 128), (520, 64),
                                    (300, 128), (300, 64)])
def test_k2_pair_walk_is_bitwise_symmetric(S, tile):
    """T = 8 and 16 at S = 1000, 5 and 9 at S = 520, 3 and 5 at A's S = 300
    (a ragged last tile each way): every entry written once, below the diagonal as computed
    and above it as the mirror; the Gram bitwise symmetric and within the
    smoke test's 1e-4 of gamma2 of the f32 plain version; the full square of
    the same arithmetic not symmetric."""
    z, _, s, _, g2 = _inputs(2, S)
    out, direct, mirror = _pair_walk(z, s, g2, tile)
    ones = torch.ones((S, S), dtype=torch.int32)
    assert torch.equal(direct, ones.tril()) and torch.equal(mirror, ones.triu(1))
    assert torch.equal(out, out.T)
    plain = sym_gram_plain(z[None], s[None], torch.tensor([g2]))[0, 0]
    assert float((out - plain).abs().max()) <= 1e-4 * g2
    full = _tile(z, z, s, g2, "sym")
    assert not torch.equal(full, full.T)


def test_k1_tile_within_twice_the_f32_error_at_a():
    """One (h, o) of K1 at A: 300 x 300 over 784 features, as K1 writes it
    (the pair walk of 128-row tiles, gamma2 on the diagonal)."""
    z, _, s, w, g2 = _inputs(3, 300)
    got, _, _ = _pair_walk(z, s, g2, 128)
    plain = sym_gram_plain(z[None], s[None], torch.tensor([g2]))[0, 0]
    e3, e32 = _errs(got, plain, _gram64(z, z, w, g2))
    print(f"K1 at (300, 300, 784): max |K - K_f64| 3xTF32 tile {e3:.3e}, f32 plain {e32:.3e}")
    assert e3 <= 2.0 * e32


@pytest.mark.parametrize("S", [300, 1000])
def test_k1_and_k2_pair_walks_agree_bitwise(S):
    """An entry's arithmetic does not depend on the tile that computes it:
    the walks of 128- and 64-row tiles (and of 128 rows at any S, K1's and
    K2's) give the same Gram bit for bit."""
    z, _, s, _, g2 = _inputs(4, S)
    assert torch.equal(_pair_walk(z, s, g2, 128)[0], _pair_walk(z, s, g2, 64)[0])


@pytest.mark.parametrize("gram_", ["K_zz", "K_zx"])
def test_k5_prescaled_tile_within_twice_the_f32_error_at_c(gram_):
    """One Gram of K5 at C, D = 64: K_zz (300 x 300, the symmetric kernel's
    pair walk) and K_zx (300 x 512, the cross kernel's tile)."""
    sz, sx, g2 = _features(5, 300, 512)
    if gram_ == "K_zz":
        sy, got = sz, _pair_walk(sz, None, g2, 128, "prescaled")[0]
    else:
        sy, got = sx, _tile(sz, sx, None, g2, "prescaled")
    plain = rbf_gram_plain(sz[None], sy[None], torch.tensor([g2]))[0]
    e3, e32 = _errs(got, plain, _gram64(sz, sy, torch.ones(F), g2))
    print(f"K5 {gram_} at C ({tuple(got.shape)}, 64): max |K - K_f64| 3xTF32 tile {e3:.3e}, "
          f"f32 plain {e32:.3e}")
    assert e3 <= 2.0 * e32


@pytest.mark.parametrize("tile", [128, 16])
def test_k5_self_gram_pair_walk_is_bitwise_symmetric(tile):
    """A ragged pre-scaled self-Gram of 37 rows (one diagonal tile at 128,
    three tiles at 16): bitwise symmetric, gamma2 on the diagonal, within
    the smoke test's 1e-4 of gamma2 of the plain version."""
    sz, _, g2 = _features(6, 37)
    out, direct, mirror = _pair_walk(sz, None, g2, tile, "prescaled")
    assert torch.equal(out, out.T) and bool((torch.diagonal(out) == g2).all())
    plain = rbf_gram_plain(sz[None], sz[None], torch.tensor([g2]))[0]
    assert float((out - plain).abs().max()) <= 1e-4 * g2


def test_k5_wrapper_takes_the_symmetric_kernel_on_one_storage():
    """rbf_gram's choice (same_storage): a tensor and a view of it with its
    shape are one storage; a clone, a slice and a view of another shape
    are not."""
    x = torch.randn(3, 37, F)
    assert same_storage(x, x) and same_storage(x, x.view(-1).view(x.shape))
    assert same_storage(x, x.reshape(3, 37, F))
    assert not same_storage(x, x.clone())
    assert not same_storage(x, x[:, :36]) and not same_storage(x, x.view(3, 37 * F // 8, 8))


def test_self_gram_reaches_k5_as_one_storage(monkeypatch):
    """kernels.rbf.gram with y = None (the deep kernel's K_zz) hands K5 one
    storage, from a non-contiguous input too, so the card takes the
    symmetric kernel; y = x.clone() (K_zx's form) takes the cross one."""
    seen = []

    def record(sx, sy, gamma2):
        seen.append(same_storage(sx, sy))
        return rbf_gram_plain(sx, sy, gamma2)

    monkeypatch.setattr(dispatch, "_rbf_gram_kernel", record)
    theta = torch.randn(2, F + 1) * 0.1
    x = torch.randn(3, 20, F)
    K = gram(theta, x)
    gram(theta, x.transpose(-1, -2).contiguous().transpose(-1, -2))
    gram(theta, x, x.clone())
    assert seen == [True, True, False]
    assert K.shape == (2, 3, 20, 20)
