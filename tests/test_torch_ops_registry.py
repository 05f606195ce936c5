"""The kernels as PyTorch operators (``vargp_torch::``): each operator's CPU
implementation against the plain version it wraps, bitwise; its fake
implementation's shapes, strides and dtypes against the real outputs, and
its checks, on fake CPU and fake CUDA tensors (no card needed); each
cost function's FLOPs against the JAX Pallas kernel's ``pl.CostEstimate``
at shapes the TPU padding leaves alone (rows, columns and features
multiples of 128), read from the ``pallas_call`` equation of the traced
program; ``ops.sq_dist`` against the JAX package's.

Two costs are held to half of a JAX estimate, because the card computes
each mirrored pair of a symmetric Gram once where the TPU kernel computes
the whole block: K5's symmetric mode (``rbf_gram_sym``) against
``_gram_3d``'s, and K1 (``sym_gram``), which runs K2's mirrored pair
walk, against ``_sym_gram_4d``'s (that is, K2's ``_sym_gram_4d_tri``
estimate, which bills the mirrored work).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from vargp_tpu.ops import dispatch as jdispatch
from vargp_tpu.ops.pallas import chol as jchol
from vargp_tpu.ops.pallas import chol_inv as jchol_inv
from vargp_tpu.ops.pallas import chol_panel as jpanel
from vargp_tpu.ops.pallas import rbf_gram as jrg
from vargp_tpu_torch.ops import dispatch as tdispatch
from vargp_tpu_torch.ops.cuda import build
from vargp_tpu_torch.ops.cuda.chol import cholesky, cholesky_plain
from vargp_tpu_torch.ops.cuda.chol_inv import chol_inv, chol_inv_plain
from vargp_tpu_torch.ops.cuda.cross_gram import cross_gram, cross_gram_plain
from vargp_tpu_torch.ops.cuda.diag_chol import diag_chol, diag_chol_chunked, diag_chol_plain
from vargp_tpu_torch.ops.cuda.marginal_moments import marginal_moments, marginal_moments_plain
from vargp_tpu_torch.ops.cuda.rbf_gram import rbf_gram, rbf_gram_plain
from vargp_tpu_torch.ops.cuda.sym_gram import sym_gram, sym_gram_plain
from vargp_tpu_torch.ops.cuda.sym_gram_tri import sym_gram_tri
from vargp_tpu_torch.ops.cuda.tri_mm import tri_mm, tri_mm_plain
from vargp_tpu_torch.utils import tracing

OPS = ("sym_gram", "sym_gram_tri", "cross_gram", "diag_chol", "diag_chol_chunked", "rbf_gram",
       "rbf_gram_sym", "cholesky", "chol_inv", "tri_mm", "marginal_moments")


def _spd(rng, G, S):
    a = rng.standard_normal((G, S, S)).astype(np.float32) / np.sqrt(S)
    return torch.tensor(a @ a.transpose(0, 2, 1) + np.eye(S, dtype=np.float32))


def _inputs(rng, name):
    """(wrapper call, plain call, the operator's inputs) at a small shape;
    K3 on a view of a larger matrix, K5 at 40 and at 3 features."""
    t = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32) * 0.3)  # noqa: E731
    if name in ("sym_gram", "sym_gram_tri"):
        z, invs, g = t(3, 20, 7), t(2, 7).exp(), t(2).exp()
        w = sym_gram if name == "sym_gram" else sym_gram_tri
        return (lambda: w(z, invs, g)), (lambda: sym_gram_plain(z, invs, g)), (z, invs, g)
    if name == "cross_gram":
        z, x, invs2, g = t(3, 20, 7), t(9, 7), t(2, 7).exp(), t(2).exp()
        return ((lambda: cross_gram(z, x, invs2, g)), (lambda: cross_gram_plain(z, x, invs2, g)),
                (z, x, invs2, g))
    if name == "diag_chol":
        A = _spd(rng, 4, 60)[:, 10:43, 10:43]
        return (lambda: diag_chol(A)), (lambda: diag_chol_plain(A)), (A,)
    if name == "diag_chol_chunked":
        A = _spd(rng, 2, 128)
        return (lambda: diag_chol_chunked(A)), (lambda: diag_chol_plain(A)), (A,)
    if name == "rbf_gram":
        sx, sy, g = t(6, 20, 40), t(6, 11, 40), t(6).exp()
        return (lambda: rbf_gram(sx, sy, g)), (lambda: rbf_gram_plain(sx, sy, g)), (sx, sy, g)
    if name == "rbf_gram_sym":
        sx, g = t(6, 20, 3), t(6).exp()
        return (lambda: rbf_gram(sx, sx, g)), (lambda: rbf_gram_plain(sx, sx, g)), (sx, g)
    if name == "tri_mm":
        L, X = torch.tril(t(2, 3, 9, 9)), t(2, 3, 9, 5)
        return (lambda: tri_mm(L, X)), (lambda: tri_mm_plain(L, X)), (L, X)
    if name == "marginal_moments":
        W, v, w, kxx = t(2, 3, 12, 5), t(2, 3, 12, 1), torch.tril(t(2, 3, 3, 4, 4)), t(2, 1, 1)
        return ((lambda: marginal_moments(W, v, w, kxx)),
                (lambda: marginal_moments_plain(W, v, w, kxx)), (W, v, w, kxx))
    K = _spd(rng, 3, 150)
    if name == "cholesky":
        return (lambda: cholesky(K)), (lambda: cholesky_plain(K)), (K,)
    return (lambda: chol_inv(K)), (lambda: chol_inv_plain(K)), (K,)


def _outs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", OPS)
def test_cpu_operator_is_the_plain_version_bitwise(name):
    """The wrapper and the operator called directly give the plain version's
    values bit for bit on the CPU, and no launch is counted."""
    wrapper, plain, args = _inputs(np.random.default_rng(len(name)), name)
    want = _outs(plain())
    op = getattr(torch.ops.vargp_torch, name)
    for got in (_outs(wrapper()), _outs(op(*args))):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert torch.equal(a, b), name
    assert sum(tracing.LAUNCHES.values()) == 0


def test_every_operator_is_registered_with_a_cost():
    assert sorted(build.COSTS) == sorted(f"vargp_torch::{n}" for n in OPS)
    for n in OPS:
        assert hasattr(torch.ops.vargp_torch, n)


@pytest.mark.parametrize("name", OPS)
def test_fake_matches_the_real_shapes_strides_and_dtypes(name):
    """Under FakeTensorMode each operator's fake implementation gives the
    real CPU output's shape, strides and dtype, with no data read."""
    _, _, args = _inputs(np.random.default_rng(3), name)
    op = getattr(torch.ops.vargp_torch, name)
    real = _outs(op(*args))
    mode = FakeTensorMode()
    with mode:
        fake_args = [mode.from_tensor(a) for a in args]
        fake = _outs(op(*fake_args))
    for r, f in zip(real, fake):
        assert (f.shape, f.stride(), f.dtype) == (r.shape, r.stride(), r.dtype), name


@pytest.mark.parametrize("stage", ["cpu", "cuda"])
def test_fake_k3_accepts_exactly_the_views_the_real_one_accepts(stage):
    """K3's fake implementation takes the strided views of diagonal blocks
    that the real one reads in place (row strides 300, 1000, 875; any h up
    to 128) and raises what it raises (too wide, not square, last stride
    not 1, batch dimensions that do not flatten to one stride), on a fake
    CPU and a fake CUDA tensor alike; on the fake card float64 raises too."""
    x = torch.zeros(4, 6, 16, 16)
    bad = {"at most 128": torch.zeros(1, 129, 129), "square": x[..., :8, :9],
           "last stride": x[0, :2].transpose(-1, -2), "flatten": x[:, :3]}
    for msg, b in bad.items():  # the real CPU implementation's refusals
        with pytest.raises(ValueError, match=msg):
            torch.ops.vargp_torch.diag_chol(b)
    with FakeTensorMode():
        for S, h in ((300, 100), (1000, 125), (875, 128), (300, 1)):
            # the leading h x h block of each of 30 S x S matrices
            L = diag_chol(torch.empty_strided((30, h, h), (S * S, S, 1), device=stage))
            assert L.shape == (30, h, h) and L.is_contiguous() and L.device.type == stage
        for msg, b in bad.items():
            with pytest.raises(ValueError, match=msg):
                diag_chol(torch.empty_strided(b.shape, b.stride(), device=stage))
        if stage == "cuda":
            with pytest.raises(ValueError, match="float32"):
                diag_chol(torch.empty(3, 16, 16, dtype=torch.float64, device=stage))


def test_fake_cuda_checks_match_the_launchers():
    """On a fake CUDA tensor the fakes raise what the CUDA implementations
    raise before a launch: non-contiguous or float64 inputs, the grid's
    limit, non-square or non-128 blocks; the shapes come out as the
    launch's.  (A fake CUDA tensor can be made here but not sliced: the
    layouts of views are made with ``empty_strided``.)"""
    with FakeTensorMode():
        z, invs, g = (torch.empty(3, 50, 7, device="cuda"), torch.empty(2, 7, device="cuda"),
                      torch.empty(2, device="cuda"))
        assert sym_gram(z, invs, g).shape == (2, 3, 50, 50)
        with pytest.raises(ValueError, match="contiguous float32"):
            sym_gram(torch.empty_strided((3, 50, 7), (7, 21, 1), device="cuda"), invs, g)
        with pytest.raises(ValueError, match="grid"):
            sym_gram_tri(torch.empty(70000, 4, 7, device="cuda"), invs, g)
        with pytest.raises(ValueError, match="contiguous float32"):
            cross_gram(z, torch.empty(9, 7, dtype=torch.float64, device="cuda"), invs, g)
        sx = torch.empty(6, 20, 40, device="cuda")
        assert rbf_gram(sx, torch.empty(6, 11, 40, device="cuda"),
                        torch.empty(6, device="cuda")).shape == (6, 20, 11)
        assert rbf_gram(sx, sx, torch.empty(6, device="cuda")).shape == (6, 20, 20)
        with pytest.raises(ValueError, match="grid"):
            big = torch.empty(70000, 2, 3, device="cuda")
            rbf_gram(big, big, torch.empty(70000, device="cuda"))
        with pytest.raises(ValueError, match="square"):
            cholesky(torch.empty(3, 4, 5, device="cuda"))
        with pytest.raises(ValueError, match="contiguous float32"):
            chol_inv(torch.empty_strided((3, 4, 4), (64, 8, 1), device="cuda"))
        L, X = chol_inv(torch.empty(3, 8, 8, device="cuda"))
        assert L.shape == X.shape == (3, 8, 8)
        with pytest.raises(ValueError, match="128x128"):
            diag_chol_chunked(torch.empty(3, 64, 64, device="cuda"))


def _jax_cost(fn, *shapes):
    """The FLOPs of the pallas_call equation in ``fn``'s traced program."""
    closed = jax.make_jaxpr(fn)(*(jnp.zeros(s, jnp.float32) for s in shapes))
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "pallas_call":
                found.append(eqn.params["cost_estimate"].flops)
            for sub in eqn.params.values():
                inner = getattr(sub, "jaxpr", None)
                if inner is not None:
                    walk(getattr(inner, "jaxpr", inner))

    walk(closed.jaxpr)
    assert len(found) == 1, found
    return found[0]


# (operator, its input shapes, the JAX kernel, the JAX call's input
# shapes, the ratio port / JAX); S, B and D multiples of 128
COST_CASES = {
    "K1 sym_gram": ("sym_gram", [(3, 256, 128), (2, 128), (2,)], jrg._sym_gram_4d,
                    [(3, 256, 128), (2, 128), (2,)], 0.5),
    "K2 sym_gram_tri": ("sym_gram_tri", [(3, 512, 128), (2, 128), (2,)],
                        jrg._sym_gram_4d_tri, [(3, 512, 128), (2, 128), (2,)], 1.0),
    "K3 diag_chol": ("diag_chol", [(5, 128, 128)], jpanel.diag_chol_pallas_t,
                     [(5, 128, 128)], 1.0),
    "K4 cross_gram": ("cross_gram", [(3, 256, 128), (128, 128), (2, 128), (2,)],
                      jrg._cross_gram_4d, [(3, 256, 128), (128, 128), (2, 128), (2,)], 1.0),
    "K5 rbf_gram": ("rbf_gram", [(4, 256, 128), (4, 128, 128), (4,)], jrg._gram_3d,
                    [(4, 256, 128), (4, 128, 128), (4,)], 1.0),
    "K5 rbf_gram_sym": ("rbf_gram_sym", [(4, 256, 128), (4,)], jrg._gram_3d,
                        [(4, 256, 128), (4, 256, 128), (4,)], 0.5),
    "K6 chol_inv": ("chol_inv", [(3, 256, 256)], jchol_inv._chol_inv_call, [(3, 256, 256)],
                    1.0),
    "K7 cholesky": ("cholesky", [(3, 256, 256)], jchol.cholesky_pallas, [(3, 256, 256)], 1.0),
    "K8 diag_chol_chunked": ("diag_chol_chunked", [(5, 128, 128)], jpanel.diag_chol_pallas,
                             [(5, 128, 128)], 1.0),
}


@pytest.mark.parametrize("case", list(COST_CASES))
def test_cost_flops_equal_the_pallas_cost_estimate(case):
    name, shapes, jfn, jshapes, ratio = COST_CASES[case]
    cost = build.cost(name, *shapes)
    assert cost.flops == ratio * _jax_cost(jfn, *jshapes)
    assert cost.bytes > 0


def test_costs_bill_the_inputs_and_outputs_once():
    """bytes: each input read once (K3-K8: the lower triangle), each output
    written once, 4 bytes an entry."""
    assert build.cost("sym_gram", (3, 10, 7), (2, 7), (2,)).bytes == 4 * (
        210 + 14 + 2 + 2 * 3 * 100)
    assert build.cost("cross_gram", (3, 10, 7), (9, 7), (2, 7), (2,)).bytes == 4 * (
        210 + 63 + 14 + 2 + 540)
    assert build.cost("rbf_gram_sym", (4, 10, 7), (4,)).bytes == 4 * (280 + 4 + 400)
    assert build.cost("diag_chol", (2, 3, 10, 10)).bytes == 4 * 6 * (55 + 100)
    assert build.cost("chol_inv", (2, 10, 10))[:2] == (2 * 2 * 1000 // 3, 4 * 2 * (55 + 200))


def test_costs_name_the_precision_of_the_kernel_that_runs():
    """The tensor-core tiles (K1, K2, K4, K5 above 16 features, K6, K7) in
    3xTF32; K3, K8 and K5's small kernel (up to 16 features) in f32; every
    class has an H100 peak in ``utils.flops.PEAKS``."""
    from vargp_tpu_torch.utils.flops import PEAKS

    tile = {name: build.cost(name, *shapes).precision
            for name, shapes, *_ in COST_CASES.values()}
    assert tile == {"sym_gram": "3xtf32", "sym_gram_tri": "3xtf32", "diag_chol": "f32",
                    "cross_gram": "3xtf32", "rbf_gram": "3xtf32", "rbf_gram_sym": "3xtf32",
                    "chol_inv": "3xtf32", "cholesky": "3xtf32", "diag_chol_chunked": "f32"}
    for D, want in ((1, "f32"), (2, "f32"), (16, "f32"), (17, "3xtf32"), (784, "3xtf32")):
        assert build.cost("rbf_gram", (3, 8, D), (3, 5, D), (3,)).precision == want
        assert build.cost("rbf_gram_sym", (3, 8, D), (3,)).precision == want
    assert {tile[n] for n in tile} <= set(PEAKS)


@pytest.mark.parametrize("shape", [((3, 9, 5), (3, 7, 5)), ((2, 4, 12, 3), (2, 4, 6, 3))])
def test_sq_dist_matches_jax(shape):
    rng = np.random.default_rng(5)
    a, b = (rng.standard_normal(s).astype(np.float32) for s in shape)
    got = tdispatch.sq_dist(torch.tensor(a), torch.tensor(b)).numpy()
    want = np.asarray(jdispatch.sq_dist(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got >= 0).all()


def test_traced_self_gram_is_one_tensor_only():
    """While ``torch.export`` traces, a self-Gram takes the symmetric
    operator only when both sides are one tensor; two inputs of one shape
    take the cross operator (fake tensors hold no storage to compare)."""
    from vargp_tpu_torch.ops.cuda.rbf_gram import same_storage

    seen = []

    class M(torch.nn.Module):
        def forward(self, a, b):
            seen.append((same_storage(a, a), same_storage(a, b)))
            return rbf_gram(a, a, b[:, 0, 0]) + rbf_gram(a, b, b[:, 0, 0])

    x = torch.zeros(3, 4, 5)
    ep = torch.export.export(M(), (x, x.clone()))
    assert seen == [(True, False)]
    ops = [str(n.target) for n in ep.graph.nodes if str(n.target).startswith("vargp_torch.")]
    assert sorted(ops) == ["vargp_torch.rbf_gram.default", "vargp_torch.rbf_gram_sym.default"]
    assert same_storage(x, x.view(-1).view(3, 4, 5)) and not same_storage(x, x.clone())
