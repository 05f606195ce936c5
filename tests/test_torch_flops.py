"""The FLOP and byte audit (``utils/flops.py``), case for case with the
JAX package's (``tests/test_flops.py``): a single product, a batched one,
a loop (the JAX version's scan trip count: here each call is seen), the
precision classes, movement bytes, ``achieved``'s consistency, a
``vargp_torch::`` operator billed by its cost function and its body not
walked, and the port's real training step at a small size.  The peaks
are the H100's (NVIDIA's data sheet), nothing of the TPU's.
"""

import numpy as np
import jax
import pytest
import torch
import torch.nn.functional as F_nn

from tests._torch_cases import build, chain, port_inputs
from vargp_tpu_torch.models import vargp as TV
from vargp_tpu_torch.ops.cuda.build import cost as op_cost
from vargp_tpu_torch.ops.cuda.rbf_gram import rbf_gram
from vargp_tpu_torch.ops.cuda.sym_gram import sym_gram, sym_gram_plain
from vargp_tpu_torch.train import loop as TL
from vargp_tpu_torch.utils import flops as F


def test_single_matmul_flops():
    # (8, 16) @ (16, 32): 2*8*16*32 = 8192 FLOPs, f32
    summary, dots, moves, ops = F.audit(lambda a, b: a @ b, torch.zeros(8, 16),
                                        torch.zeros(16, 32))
    assert summary["gflop_f32"] == pytest.approx(8192 / 1e9)
    assert summary["gflop_vargp_torch"] == 0.0 and not ops
    assert list(dots.values()) == [8192]


def test_precision_classes():
    a, b = torch.zeros(4, 4), torch.zeros(4, 4)
    fl = 2 * 4 * 4 * 4 / 1e9
    summary = F.audit(lambda: (a @ b, a.double() @ b.double()))[0]
    assert summary["gflop_f32"] == pytest.approx(fl)
    assert summary["gflop_f64"] == pytest.approx(fl)
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        summary = F.audit(lambda: a @ b)[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert summary["gflop_tf32"] == pytest.approx(fl) and summary["gflop_f32"] == 0.0


def test_batched_product_counts_batch_dims():
    # (3, 8, 16) @ (3, 16, 32) through einsum: 3 * 2*8*16*32
    summary = F.audit(lambda a, b: torch.einsum("bij,bjk->bik", a, b), torch.zeros(3, 8, 16),
                      torch.zeros(3, 16, 32))[0]
    assert summary["gflop_f32"] == pytest.approx(3 * 8192 / 1e9)


def test_loop_counts_every_call():
    def f(a):
        c = a
        for _ in range(5):
            c = c @ a
        return c

    assert F.audit(f, torch.zeros(8, 8))[0]["gflop_f32"] == pytest.approx(5 * 2 * 8 ** 3 / 1e9)


def test_factorisation_and_solve_flops():
    A = torch.eye(6).expand(2, 6, 6).contiguous()
    B = torch.zeros(2, 6, 3)
    summary, dots, _, _ = F.audit(
        lambda: torch.linalg.solve_triangular(torch.linalg.cholesky(A), B, upper=False))
    assert summary["gflop_f32"] == pytest.approx((2 * 6 ** 3 // 3 + 2 * 36 * 3) / 1e9)
    assert {k[0][0] for k in dots} == {"aten::linalg_cholesky_ex", "aten::linalg_solve_triangular"}


def test_movement_bytes_counted():
    def f(a):
        return F_nn.pad(a, (0, 0, 0, 8)).T.contiguous().reshape(-1)

    summary, _, moves, _ = F.audit(f, torch.zeros(8, 16))
    # pad -> (16, 16) f32 = 1024 B; the transpose made contiguous likewise
    assert moves["aten::constant_pad_nd"] == 16 * 16 * 4
    assert moves["aten::clone"] == 16 * 16 * 4
    assert summary["movement_mb"] == pytest.approx(2 * 1024 / 1e6)
    assert summary["sol_ms"] == pytest.approx(2048 / F.HBM_BYTES_PER_S * 1e3)


def test_achieved_consistency():
    # 67 GFLOP of f32 products: 1 ms at the H100's 67 TFLOP/s
    summary = dict(gflop_f32=67.0, gflop_vargp_torch=0.0, movement_mb=0.0, operator_mb=0.0,
                   sol_ms=1.0)
    ach = F.achieved(summary, measured_s=2e-3)
    assert ach["pct_sol"] == pytest.approx(50.0)
    assert ach["tflops"] == pytest.approx(67.0 / 2e-3 / 1e3)


def test_h100_peaks_only():
    assert (F.F32_FLOPS, F.TF32_FLOPS, F.HBM_BYTES_PER_S) == (67e12, 495e12, 3.35e12)
    assert F.TF32X3_FLOPS == pytest.approx(165e12)
    assert not hasattr(F, "HIGHEST_TFLOPS") and not hasattr(F, "HIGH_TFLOPS")


def test_operator_billed_by_its_cost_and_not_walked():
    """K1's operator: its cost function's FLOPs and bytes in the operators'
    bucket at the 3xTF32 rate; the plain version's einsum that runs inside
    it on the CPU is not seen."""
    rng = np.random.default_rng(0)
    z = torch.tensor(rng.standard_normal((3, 20, 7)), dtype=torch.float32)
    invs, g = torch.ones(2, 7), torch.ones(2)
    summary, dots, moves, ops = F.audit(lambda: sym_gram(z, invs, g))
    flops, nbytes, precision = op_cost("sym_gram", z.shape, invs.shape, g.shape)
    assert precision == "3xtf32"
    assert ops == {"vargp_torch::sym_gram": dict(flops=flops, bytes=nbytes, calls=1)}
    assert summary["gflop_vargp_torch"] == pytest.approx(flops / 1e9)
    assert not dots and not moves
    assert summary["sol_ms"] == pytest.approx(
        max(flops / F.TF32X3_FLOPS, nbytes / F.HBM_BYTES_PER_S) * 1e3)
    # the plain version alone is walked: its einsum is a product
    assert F.audit(lambda: sym_gram_plain(z, invs, g))[0]["gflop_f32"] > 0


@pytest.mark.parametrize("D, peak", [(2, "F32_FLOPS"), (40, "TF32X3_FLOPS")])
def test_k5_billed_at_the_rate_of_the_kernel_that_runs(D, peak):
    """K5 up to 16 features runs its small f32 kernel, and is billed at the
    f32 rate; above, its 3xTF32 tile at 165 TFLOP/s.  Each launch is held
    to its own bound, and the launches' bounds add."""
    rng = np.random.default_rng(1)
    sx, sy = (torch.tensor(rng.standard_normal(s), dtype=torch.float32)
              for s in ((6, 300, D), (6, 400, D)))
    g = torch.ones(6)
    summary, _, _, ops = F.audit(lambda: (rbf_gram(sx, sy, g), rbf_gram(sx, sx, g)))
    want = 0.0
    for name, shapes in (("rbf_gram", (sx.shape, sy.shape, g.shape)),
                         ("rbf_gram_sym", (sx.shape, g.shape))):
        flops, nbytes, _ = op_cost(name, *shapes)
        assert ops[f"vargp_torch::{name}"] == dict(flops=flops, bytes=nbytes, calls=1)
        want += max(flops / getattr(F, peak), nbytes / F.HBM_BYTES_PER_S)
    assert summary["sol_ms"] == pytest.approx(want * 1e3)


def test_audit_of_the_training_step():
    """One ``elbo_step`` of the small case (a 2-task chain, S = 192 in two
    96-row blocks): K1 once, K3 twice, K4 once in the operators' bucket;
    the backward's products seen beside the forward's; a speed of light."""
    m = build("small")
    prev, mask = chain(m, "chain")
    tp, tprev, tprior, x, y, w, noise, tmask = port_inputs(m, prev, mask, jax.random.key(3))
    opt = TL.make_optimizer(TL.TrainHyperparams(lr=3e-3))

    def step():
        return TL.elbo_step(tp, opt.init(tp), tprev, tprior, x, y, w, noise, cfg=m["tcfg"],
                            opt=opt, beta=10.0, n_train=1000, chain_mask=tmask, device="cpu")

    def forward():
        with torch.no_grad():
            return TV.loss(tp, tprev, tprior, x, y, noise, m["tcfg"], weights=w, device="cpu")

    summary, dots, moves, ops = F.audit(step)
    fwd = F.audit(forward)[0]
    assert {k: v["calls"] for k, v in ops.items()} == {
        "vargp_torch::sym_gram": 1, "vargp_torch::diag_chol": 2, "vargp_torch::cross_gram": 1}
    assert summary["gflop_f32"] > 1.5 * fwd["gflop_f32"] > 0
    assert summary["gflop_vargp_torch"] == pytest.approx(fwd["gflop_vargp_torch"])
    assert summary["movement_mb"] > 0 and np.isfinite(summary["sol_ms"]) and summary["sol_ms"] > 0
    assert F.achieved(summary, 1e-3)["pct_sol"] == pytest.approx(summary["sol_ms"] * 100)
