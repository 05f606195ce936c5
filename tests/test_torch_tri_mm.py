"""``vargp_torch::tri_mm`` (K9, ``csrc/tri_mm.cu``) on the CPU: its plain
version, its fake implementation and checks, the route
``whitened_marginal_diag_factored`` takes for W = L^-1 K_zx, and the
contract the kernel skips on: every factorisation route gives an L^-1
that is exactly zero above its diagonal, so the triangular product is the
dense one.  The kernel itself runs on the card (``chip_smoke.py``'s K9
phase)."""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from vargp_tpu_torch.gpmath import conditional
from vargp_tpu_torch.gpmath.conditional import takes_tri_mm, whitened_marginal_diag_factored
from vargp_tpu_torch.ops import dispatch
from vargp_tpu_torch.ops.cuda.tri_mm import tri_mm, tri_mm_plain
from vargp_tpu_torch.utils import tracing


def _t(rng, *shape):
    return torch.tensor(rng.standard_normal(shape).astype(np.float32))


def _spd(rng, G, S):
    a = rng.standard_normal((G, S, S)).astype(np.float32) / np.sqrt(S)
    return torch.tensor(a @ a.transpose(0, 2, 1) + np.eye(S), dtype=torch.float32)


@pytest.mark.parametrize("lead, S, N", [((), 6, 3), ((4,), 7, 5), ((2, 3), 9, 4), ((2, 3), 1, 1)])
def test_plain_version_is_torch_matmul_bitwise(lead, S, N):
    """On the CPU the operator is ``torch.matmul`` bit for bit, whatever
    lies above L's diagonal, and launches nothing."""
    rng = np.random.default_rng(S * N)
    L, X = _t(rng, *lead, S, S), _t(rng, *lead, S, N)
    before = sum(tracing.LAUNCHES.values())
    for got in (tri_mm(L, X), torch.ops.vargp_torch.tri_mm(L, X), tri_mm_plain(L, X)):
        assert torch.equal(got, torch.matmul(L, X))
    assert sum(tracing.LAUNCHES.values()) == before


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_fake_gives_the_real_shape_stride_and_dtype(device):
    """The fake implementation's output is the real one's (contiguous
    (..., S, N) float32), on a fake CPU and a fake CUDA tensor."""
    rng = np.random.default_rng(1)
    L, X = torch.tril(_t(rng, 2, 3, 11, 11)), _t(rng, 2, 3, 11, 6)
    real = tri_mm(L, X)
    with FakeTensorMode():
        fake = tri_mm(torch.empty(2, 3, 11, 11, device=device),
                      torch.empty(2, 3, 11, 6, device=device))
    assert (fake.shape, fake.stride(), fake.dtype) == (real.shape, real.stride(), real.dtype)
    assert fake.device.type == device


BAD = {
    "non-square L": ((3, 5, 6), (3, 5, 2)),
    "S mismatch": ((3, 5, 5), (3, 6, 2)),
    "leading dims": ((3, 5, 5), (2, 5, 2)),
    "broadcast leading dims": ((1, 5, 5), (3, 5, 2)),
    "rank": ((5, 5), (1, 5, 2)),
    "vector L": ((5,), (5, 2)),
}


@pytest.mark.parametrize("case", list(BAD))
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_bad_shapes_raise(case, device):
    """Shapes the kernel does not take raise on every device: on real CPU
    tensors (the plain version) and on fake CPU and CUDA tensors."""
    ls, xs = BAD[case]
    if device == "cpu":
        with pytest.raises(ValueError, match="tri_mm"):
            tri_mm(torch.zeros(ls), torch.zeros(xs))
    with FakeTensorMode():
        with pytest.raises(ValueError, match="tri_mm"):
            tri_mm(torch.empty(ls, device=device), torch.empty(xs, device=device))


def test_card_path_takes_contiguous_float32_only():
    """On the card (fake CUDA tensors) float64 and strided inputs raise,
    as the launch would refuse them; on the CPU the plain version takes
    them."""
    with FakeTensorMode():
        L, X = torch.empty(3, 8, 8, device="cuda"), torch.empty(3, 8, 4, device="cuda")
        assert tri_mm(L, X).shape == (3, 8, 4)
        with pytest.raises(ValueError, match="contiguous float32"):
            tri_mm(L.double(), X.double())
        with pytest.raises(ValueError, match="contiguous float32"):
            tri_mm(L, torch.empty_strided((3, 8, 4), (64, 1, 8), device="cuda"))
        with pytest.raises(ValueError, match="devices"):
            tri_mm(L, torch.empty(3, 8, 4))
    L64 = torch.eye(4, dtype=torch.float64)[None]
    assert tri_mm(L64, L64).dtype == torch.float64


def _marginal_inputs(device, *, H=2, O=3, T=2, M=4, B=5, grad=False, L_lead=None):
    """Fake inputs of whitened_marginal_diag_factored at S = T M."""
    S = T * M
    L_lead = (H, O) if L_lead is None else L_lead
    return dict(
        L_inv=torch.empty(*L_lead, S, S, device=device, requires_grad=grad),
        v_mean=torch.empty(H, O, S, 1, device=device),
        w=torch.empty(H, O, T, M, M, device=device),
        Kzx=torch.empty(H, O, S, B, device=device),
        Kxx_diag=torch.empty(H, 1, 1, device=device),
    )


ROUTES = {
    # case: (device, requires_grad, L_inv's leading dims, takes tri_mm)
    "card": ("cuda", False, None, True),
    "card, requires grad": ("cuda", True, None, False),
    "card, broadcast L_inv": ("cuda", False, (1, 3), False),
    "cpu": ("cpu", False, None, False),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_marginal_routes_w_by_device_grad_and_shapes(case, monkeypatch):
    """W = L^-1 K_zx takes tri_mm on the card when no operand requires
    grad and the leading dimensions agree; the dense mm_h otherwise (under
    grad, for broadcast operands, on the CPU)."""
    device, grad, lead, want = ROUTES[case]
    calls = []

    def spy(name, fn):
        def call(*a):
            calls.append(name)
            return fn(*a)
        return call

    monkeypatch.setattr(conditional, "tri_mm", spy("tri_mm", conditional.tri_mm))
    monkeypatch.setattr(conditional, "mm_h", spy("mm_h", conditional.mm_h))
    # the route reads the operands' flags, not the grad mode: no_grad keeps
    # autograd from recording on fake CUDA tensors, which this host cannot do
    with FakeTensorMode(), torch.no_grad():
        args = _marginal_inputs(device, grad=grad, L_lead=lead)
        assert takes_tri_mm(args["L_inv"], args["Kzx"]) is want
        f_mean, f_var = whitened_marginal_diag_factored(**args)
    assert calls == (["tri_mm"] if want else ["mm_h"])
    assert f_mean.shape == f_var.shape == (2, 3, 5)


def test_gradient_under_grad_is_the_dense_products():
    """Under grad the marginal's values and gradients are bitwise those of
    the dense products it has always taken (W = L^-1 K_zx by mm_h)."""
    rng = np.random.default_rng(7)
    H, O, T, M, B = 2, 3, 2, 4, 5
    S = T * M
    leaves = [torch.tril(_t(rng, H, O, S, S)), _t(rng, H, O, S, 1), _t(rng, H, O, T, M, M),
              _t(rng, H, O, S, B), _t(rng, H, 1, 1).exp() + 10.0]
    ours = [t.clone().requires_grad_() for t in leaves]
    ref = [t.clone().requires_grad_() for t in leaves]
    f_mean, f_var = whitened_marginal_diag_factored(*ours)
    L_inv, v, w, Kzx, kxx = ref
    W = torch.matmul(L_inv, Kzx)
    r_mean = torch.einsum("...mi,...mb->...b", v, W)
    C = torch.matmul(w.transpose(-1, -2), W.reshape(H, O, T, M, B))
    r_var = torch.clamp(kxx - torch.sum(W * W, dim=-2) + torch.sum(C * C, dim=(-3, -2)), min=0.0)
    assert torch.equal(f_mean, r_mean) and torch.equal(f_var, r_var)
    g = torch.autograd.grad((f_mean.sum() + f_var.sum()), ours)
    r = torch.autograd.grad((r_mean.sum() + r_var.sum()), ref)
    for a, b in zip(g, r):
        assert torch.equal(a, b)


def _route_inverse(K, monkeypatch, knob="xla"):
    monkeypatch.setenv("VARGP_TPU_CHOLINV", knob)
    L, L_inv = dispatch.chol_and_inv(K)
    return L, L_inv


# route: (S, the blocked route's block for S or None, the knob; pallas
# takes K6 whatever the block)
CONTRACT = {
    "blocked S = 300 (d = 100)": (300, 100, "xla"),
    "blocked S = 1000 (d = 125)": (1000, 125, "xla"),
    "padded identity S = 370": (370, None, "xla"),
    "one block and Newton S = 150": (150, None, "xla"),
    "VARGP_TPU_CHOLINV=pallas (K6's plain version) S = 300": (300, 100, "pallas"),
}


@pytest.mark.parametrize("case", list(CONTRACT))
def test_every_factorisation_route_gives_an_inverse_zero_above_its_diagonal(case, monkeypatch):
    """The contract tri_mm skips on: each route's L^-1 is exactly 0 above
    the diagonal, so tril(L^-1) K_zx, which the kernel computes, is the
    dense L^-1 K_zx bit for bit on the CPU."""
    S, block, knob = CONTRACT[case]
    assert dispatch._pick_block(S) == block
    if case.startswith("padded"):  # no friendly divisor, a small identity pad
        assert -(-S // 128) * 128 - S < 0.15 * S
    rng = np.random.default_rng(S)
    K = _spd(rng, 2, S)
    _, L_inv = _route_inverse(K, monkeypatch, knob)
    assert L_inv.shape == (2, S, S)
    assert torch.count_nonzero(torch.triu(L_inv, 1)) == 0
    assert torch.isfinite(L_inv).all()
    X = _t(rng, 2, S, 3)
    assert torch.equal(torch.matmul(torch.tril(L_inv), X), torch.matmul(L_inv, X))
