"""``vargp_torch::marginal_moments`` (K10, ``csrc/marginal_moments.cu``) on
the CPU: its plain version (the chain of products, squares and sums the
predictive marginal has always made), its fake implementation and checks,
the route ``whitened_marginal_diag_factored`` takes for W's readers, the
gradient under grad, and the contract the kernel skips on: every w_t the
factored posterior gives is exactly zero above its diagonal.  The kernel
itself runs on the card: the test below that ends in ``on_the_card``
(``python3 -m pytest --noconftest tests/test_torch_marginal_moments.py -k
on_the_card`` there, where no JAX is installed; it skips without a card)
and ``chip_smoke.py --phases=marginal_moments``."""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from vargp_tpu_torch.gpmath import conditional, vec2tril
from vargp_tpu_torch.gpmath.conditional import (ar_joint_posterior_factored,
                                                takes_marginal_moments,
                                                whitened_marginal_diag_factored)
from vargp_tpu_torch.ops import dispatch
from vargp_tpu_torch.ops.cuda import marginal_moments as marginal_moments_mod
from vargp_tpu_torch.ops.cuda.build import cost
from vargp_tpu_torch.ops.cuda.marginal_moments import (MAX_M, marginal_moments,
                                                       marginal_moments_plain)
from vargp_tpu_torch.utils import tracing

# (H, O, T, M, B): S-MNIST's and P-MNIST's task blocks (M = 60, 100), an odd
# M, a ragged batch (B = 300, no multiple of the kernel's 64 columns), one task
SHAPES = {
    "M = 60, B = 512": (2, 3, 5, 60, 512),
    "M = 100, B = 512": (2, 3, 3, 100, 512),
    "M = 100, B = 300": (2, 3, 2, 100, 300),
    "M = 7, B = 300": (2, 3, 4, 7, 300),
    "T = 1, M = 60, B = 33": (3, 2, 1, 60, 33),
}


def _t(rng, *shape, scale=1.0):
    return torch.tensor((rng.standard_normal(shape) * scale).astype(np.float32))


def _inputs(rng, H, O, T, M, B):
    """Random operands at the marginal's shapes: w lower triangular, Kxx
    above the sum of W's squares so that f_var keeps its cancellation."""
    S = T * M
    W = _t(rng, H, O, S, B, scale=S ** -0.5)
    return W, _t(rng, H, O, S, 1), torch.tril(_t(rng, H, O, T, M, M, scale=M ** -0.5)), \
        _t(rng, H, 1, 1, scale=0.1).exp() + 1.0


def _chain(W, v, w, kxx):
    """The marginal's readers as ``whitened_marginal_diag_factored`` wrote
    them before the kernel: einsum, square and sum, the task products by
    matmul, square and sum, the clamp."""
    T, M = w.shape[-3], w.shape[-1]
    f_mean = torch.einsum("...mi,...mb->...b", v, W)
    diag1 = torch.sum(torch.square(W), dim=-2)
    C = torch.matmul(w.transpose(-1, -2), W.reshape(*W.shape[:-2], T, M, W.shape[-1]))
    diag2 = torch.sum(torch.square(C), dim=(-3, -2))
    return f_mean, torch.clamp(kxx - diag1 + diag2, min=0.0)


@pytest.mark.parametrize("case", list(SHAPES))
def test_plain_version_is_the_chain_bitwise(case):
    """On the CPU the operator, its wrapper and the plain version give the
    chain's values bit for bit, and launch nothing."""
    rng = np.random.default_rng(len(case))
    args = _inputs(rng, *SHAPES[case])
    want = _chain(*args)
    before = sum(tracing.LAUNCHES.values())
    for got in (marginal_moments(*args), torch.ops.vargp_torch.marginal_moments(*args),
                marginal_moments_plain(*args)):
        assert len(got) == 2
        for a, b in zip(got, want):
            assert torch.equal(a, b), case
    assert sum(tracing.LAUNCHES.values()) == before


@pytest.mark.parametrize("case", ["M = 60, B = 512", "M = 7, B = 300"])
def test_marginal_on_the_cpu_is_the_dense_chain_bitwise(case):
    """whitened_marginal_diag_factored on the CPU: W by the dense product,
    then the chain, bit for bit."""
    H, O, T, M, B = SHAPES[case]
    rng = np.random.default_rng(M)
    W, v, w, kxx = _inputs(rng, H, O, T, M, B)
    L_inv, Kzx = torch.tril(_t(rng, H, O, T * M, T * M)), _t(rng, H, O, T * M, B)
    got = whitened_marginal_diag_factored(L_inv, v, w, Kzx, kxx)
    want = _chain(torch.matmul(L_inv, Kzx), v, w, kxx)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["M = 60, B = 512", "T = 1, M = 60, B = 33"])
def test_gradient_under_grad_is_the_chain(case):
    """Under grad the marginal keeps the dense chain: its values and every
    gradient bitwise the chain's."""
    H, O, T, M, B = SHAPES[case]
    rng = np.random.default_rng(T * M)
    S = T * M
    leaves = [torch.tril(_t(rng, H, O, S, S, scale=S ** -0.5)), _t(rng, H, O, S, 1),
              torch.tril(_t(rng, H, O, T, M, M, scale=M ** -0.5)), _t(rng, H, O, S, B),
              _t(rng, H, 1, 1).exp() + 10.0]
    ours = [t.clone().requires_grad_() for t in leaves]
    ref = [t.clone().requires_grad_() for t in leaves]
    f_mean, f_var = whitened_marginal_diag_factored(*ours)
    L_inv, v, w, Kzx, kxx = ref
    r_mean, r_var = _chain(torch.matmul(L_inv, Kzx), v, w, kxx)
    assert torch.equal(f_mean, r_mean) and torch.equal(f_var, r_var)
    g = torch.autograd.grad(f_mean.sum() + f_var.sum(), ours)
    r = torch.autograd.grad(r_mean.sum() + r_var.sum(), ref)
    for a, b in zip(g, r):
        assert torch.equal(a, b)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("case", ["M = 100, B = 300", "M = 7, B = 300"])
def test_fake_gives_the_real_shapes_strides_and_dtype(device, case):
    """The fake implementation's outputs are the real ones' (two contiguous
    (H, O, B) float32 tensors), on a fake CPU and a fake CUDA tensor."""
    H, O, T, M, B = SHAPES[case]
    real = marginal_moments(*_inputs(np.random.default_rng(0), H, O, T, M, B))
    S = T * M
    with FakeTensorMode():
        fake = marginal_moments(torch.empty(H, O, S, B, device=device),
                                torch.empty(H, O, S, 1, device=device),
                                torch.empty(H, O, T, M, M, device=device),
                                torch.empty(H, 1, 1, device=device))
    assert len(fake) == len(real) == 2
    for f, r in zip(fake, real):
        assert (f.shape, f.stride(), f.dtype) == (r.shape, r.stride(), r.dtype) == (
            (H, O, B), (O * B, B, 1), torch.float32)
        assert f.device.type == device


# (W, v, w, kxx) shapes the operator refuses
BAD = {
    "S != T M": ((2, 3, 12, 5), (2, 3, 12, 1), (2, 3, 2, 5, 5), (2, 1, 1)),
    "w not square": ((2, 3, 12, 5), (2, 3, 12, 1), (2, 3, 3, 4, 3), (2, 1, 1)),
    "v's leading dims": ((2, 3, 12, 5), (1, 3, 12, 1), (2, 3, 3, 4, 4), (2, 1, 1)),
    "w's leading dims": ((2, 3, 12, 5), (2, 3, 12, 1), (2, 1, 3, 4, 4), (2, 1, 1)),
    "kxx's leading dim": ((2, 3, 12, 5), (2, 3, 12, 1), (2, 3, 3, 4, 4), (1, 1, 1)),
    "v's rows": ((2, 3, 12, 5), (2, 3, 11, 1), (2, 3, 3, 4, 4), (2, 1, 1)),
    "W's rank": ((6, 12, 5), (6, 12, 1), (6, 3, 4, 4), (6, 1, 1)),
}


@pytest.mark.parametrize("case", list(BAD))
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_bad_shapes_raise(case, device):
    """Shapes the kernel does not take raise on every device: on real CPU
    tensors (the plain version) and on fake CPU and CUDA tensors."""
    shapes = BAD[case]
    if device == "cpu":
        with pytest.raises(ValueError, match="marginal_moments"):
            marginal_moments(*(torch.zeros(s) for s in shapes))
    with FakeTensorMode():
        with pytest.raises(ValueError, match="marginal_moments"):
            marginal_moments(*(torch.empty(s, device=device) for s in shapes))


def test_card_path_takes_contiguous_float32_and_blocks_up_to_max_m():
    """On the card (fake CUDA tensors) float64 and strided inputs raise, as
    the launch would refuse them, and so do task blocks above MAX_M rows;
    on the CPU the plain version takes all three."""
    with FakeTensorMode():
        W, v = torch.empty(2, 3, 12, 5, device="cuda"), torch.empty(2, 3, 12, 1, device="cuda")
        w, kxx = torch.empty(2, 3, 3, 4, 4, device="cuda"), torch.empty(2, 1, 1, device="cuda")
        assert marginal_moments(W, v, w, kxx)[1].shape == (2, 3, 5)
        with pytest.raises(ValueError, match="contiguous float32"):
            marginal_moments(W.double(), v.double(), w.double(), kxx.double())
        with pytest.raises(ValueError, match="contiguous float32"):
            marginal_moments(torch.empty_strided((2, 3, 12, 5), (180, 60, 1, 12), device="cuda"),
                             v, w, kxx)
        with pytest.raises(ValueError, match="devices"):
            marginal_moments(W, v, w, torch.empty(2, 1, 1))
        M = MAX_M + 1
        with pytest.raises(ValueError, match="exceed"):
            marginal_moments(torch.empty(1, 1, M, 5, device="cuda"),
                             torch.empty(1, 1, M, 1, device="cuda"),
                             torch.empty(1, 1, 1, M, M, device="cuda"),
                             torch.empty(1, 1, 1, device="cuda"))
    args = [a.double() for a in _inputs(np.random.default_rng(2), 1, 1, 1, MAX_M + 1, 3)]
    assert marginal_moments(*args)[0].dtype == torch.float64


def _marginal_args(device, *, H=2, O=3, T=2, M=4, B=5, grad=None, lead=None):
    """Fake inputs of whitened_marginal_diag_factored at S = T M; ``grad``
    names the one operand that records a gradient, ``lead`` maps an operand
    to leading dimensions of its own (a broadcast)."""
    S = T * M
    lead = lead or {}
    shapes = dict(L_inv=(H, O, S, S), v_mean=(H, O, S, 1), w=(H, O, T, M, M), Kzx=(H, O, S, B),
                  Kxx_diag=(H, 1, 1))
    tail = dict(L_inv=2, v_mean=2, w=3, Kzx=2, Kxx_diag=2)
    return {n: torch.empty(*lead.get(n, s[:-tail[n]]), *s[-tail[n]:], device=device,
                           requires_grad=n == grad) for n, s in shapes.items()}


ROUTES = {
    # case: (device, the operand recording a gradient, broadcast operands,
    # the task block's rows, takes marginal_moments)
    "card": ("cuda", None, None, 4, True),
    "card, M = 100": ("cuda", None, None, 100, True),
    "card, v requires grad": ("cuda", "v_mean", None, 4, False),
    "card, Kxx requires grad": ("cuda", "Kxx_diag", None, 4, False),
    "card, broadcast w": ("cuda", None, {"w": (1, 3)}, 4, False),
    "card, broadcast v": ("cuda", None, {"v_mean": (3,)}, 4, False),
    "card, broadcast Kxx": ("cuda", None, {"Kxx_diag": (1,)}, 4, False),
    "card, M above MAX_M": ("cuda", None, None, MAX_M + 1, False),
    "cpu": ("cpu", None, None, 4, False),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_marginal_routes_the_readers_by_device_grad_and_shapes(case, monkeypatch):
    """W's readers take marginal_moments on the card when no operand
    records a gradient, the leading dimensions agree and the task blocks
    fit the kernel; the dense chain otherwise (under grad, for broadcast
    operands, on the CPU)."""
    device, grad, lead, M, want = ROUTES[case]
    calls = []

    def spy(name, fn):
        def call(*a):
            calls.append(name)
            return fn(*a)
        return call

    monkeypatch.setattr(conditional, "marginal_moments",
                        spy("marginal_moments", conditional.marginal_moments))
    monkeypatch.setattr(conditional, "marginal_moments_plain",
                        spy("plain", conditional.marginal_moments_plain))
    # the route reads the operands' flags, not the grad mode: no_grad keeps
    # autograd from recording on fake CUDA tensors, which this host cannot do
    with FakeTensorMode(), torch.no_grad():
        args = _marginal_args(device, M=M, grad=grad, lead=lead)
        W = torch.empty(2, 3, 2 * M, 5, device=device)
        assert takes_marginal_moments(W, args["v_mean"], args["w"], args["Kxx_diag"]) is want
        f_mean, f_var = whitened_marginal_diag_factored(**args)
    assert calls == (["marginal_moments"] if want else ["plain"])
    assert f_mean.shape == f_var.shape == (2, 3, 5)


# route: (S, M, the blocked route's block for S or None, how L^-1 is made:
# the default ``chol_and_inv`` under the knob's value, or K6's
# ``chol_and_inv_fused``, which the exported predictor takes); the task
# blocks straddle the factorisation's blocks where S has them
CONTRACT = {
    "blocked S = 300 (d = 100), M = 60": (300, 60, 100, "xla"),
    "blocked S = 1000 (d = 125), M = 100": (1000, 100, 125, "xla"),
    "padded identity S = 370, M = 74": (370, 74, None, "xla"),
    "one block and Newton S = 150, M = 50": (150, 50, None, "xla"),
    "one block and Newton S = 70, M = 7": (70, 7, None, "xla"),
    "VARGP_TPU_CHOLINV=pallas (K6's plain version) S = 300, M = 60": (300, 60, 100, "pallas"),
    "chol_and_inv_fused (K6's plain version) S = 300, M = 100": (300, 100, 100, "fused"),
}


@pytest.mark.parametrize("case", list(CONTRACT))
def test_the_factored_posterior_gives_w_zero_above_its_diagonal(case, monkeypatch):
    """The contract the kernel skips on: under every factorisation route,
    each w_t = inv(L_tt) u_tril_t that ar_joint_posterior_factored gives
    (u_tril unpacked from its vector) is exactly 0 above its diagonal, so
    the chain on tril(w) is the chain on w bit for bit."""
    S, M, block, route = CONTRACT[case]
    assert dispatch._pick_block(S) == block
    rng = np.random.default_rng(S + M)
    T, O = S // M, 2
    a = rng.standard_normal((O, S, S)).astype(np.float32) / np.sqrt(S)
    K = torch.tensor(a @ a.transpose(0, 2, 1) + np.eye(S), dtype=torch.float32)
    if route == "fused":
        L, L_inv = dispatch.chol_and_inv_fused(K)
    else:
        monkeypatch.setenv("VARGP_TPU_CHOLINV", route)
        L, L_inv = dispatch.chol_and_inv(K)
    u_means = [_t(rng, O, M, 1) for _ in range(T)]
    u_trils = [vec2tril(_t(rng, O, M * (M + 1) // 2, scale=0.3), M) for _ in range(T)]
    post = ar_joint_posterior_factored(L, L_inv, u_means, u_trils)
    assert post.w.shape == (O, T, M, M)
    assert torch.isfinite(post.w).all()
    assert torch.count_nonzero(torch.triu(post.w, 1)) == 0
    W, kxx = _t(rng, 1, O, S, 9), torch.ones(1, 1, 1) * 2.0
    v, w = post.v[None], post.w[None]
    for x, y in zip(marginal_moments_plain(W, v, torch.tril(w), kxx),
                    marginal_moments_plain(W, v, w, kxx)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n, offset", [(512, 0), (301, 0), (7, 0), (512, 1)])
def test_rows_of_4_pads_what_the_tensor_copies_cannot_read(n, offset):
    """The launch's operands: rows of a multiple of 4 entries from a 16-byte
    aligned base go in as they are; any other goes in as a zero-padded
    copy whose row stride is the next multiple of 4, its entries the same."""
    base = torch.arange(2 * 3 * (n + offset), dtype=torch.float32)
    x = base[offset:offset + 2 * 3 * n].view(2, 3, n)
    got, ld = marginal_moments_mod._rows_of_4(x)
    assert ld == -(-n // 4) * 4 and got.shape == (2, 3, ld) and got.data_ptr() % 16 == 0
    assert (got is x) == (ld == n and offset == 0)
    assert torch.equal(got[..., :n], x) and not got[..., n:].any()


def test_cost_bills_the_triangle_and_each_byte_once():
    """A matrix: 6 S B for f_mean, diag1 and diag2's squares, T M (M + 1) B
    for C's triangle, 2 B for the tail; W, v, w's lower triangles and kxx
    read, both outputs written, 4 bytes an entry; at the 3xTF32 rate, the
    card's fastest for f32-accurate products."""
    H, O, T, M, B = 2, 3, 4, 5, 7
    S, G = T * M, H * O
    c = cost("marginal_moments", (H, O, S, B), (H, O, S, 1), (H, O, T, M, M), (H, 1, 1))
    assert c.flops == G * B * (6 * S + T * M * (M + 1) + 2)
    assert c.bytes == 4 * (G * S * B + G * S + G * T * 15 + H + 2 * G * B)
    assert c.precision == "3xtf32"


def _operands(H, O, T, M, B, seed):
    """The marginal's operands in float64 as the model makes them: L^-1 of
    an RBF Gram over the chain (with jitter), K_zx against B rows, the
    factored posterior's v and w from random u_mean and u_tril, kxx its
    gamma^2."""
    g = torch.Generator().manual_seed(seed)
    S, D = T * M, 16
    z = torch.randn(O, S, D, generator=g, dtype=torch.float64) / D ** 0.5
    x = torch.randn(B, D, generator=g, dtype=torch.float64) / D ** 0.5
    g2 = torch.exp(0.2 * torch.randn(H, generator=g, dtype=torch.float64))
    K = g2[:, None, None, None] * torch.exp(-0.5 * torch.cdist(z, z) ** 2)
    K = K + 1e-4 * torch.eye(S, dtype=torch.float64)
    L = torch.linalg.cholesky(K)
    L_inv = torch.linalg.solve_triangular(L, torch.eye(S, dtype=torch.float64), upper=False)
    Kzx = g2[:, None, None, None] * torch.exp(-0.5 * torch.cdist(z, x[None]) ** 2)
    u_mean = torch.randn(H, O, T, M, 1, generator=g, dtype=torch.float64)
    u_tril = torch.tril(0.1 * torch.randn(H, O, T, M, M, generator=g, dtype=torch.float64))
    u_tril = u_tril + torch.eye(M, dtype=torch.float64)
    Dinv = torch.stack([L_inv[..., t * M:(t + 1) * M, t * M:(t + 1) * M] for t in range(T)], -3)
    w, v = Dinv @ u_tril, (Dinv @ u_mean).reshape(H, O, S, 1)
    return L_inv @ Kzx, v, w, g2[:, None, None]


@pytest.mark.parametrize("case", list(SHAPES))
def test_kernel_against_the_plain_version_and_float64_on_the_card(case):
    """K10 on the card, one launch a call: within 1e-5 of the largest
    f_var of the f32 plain version on the same card, and within twice the
    plain version's error from the float64 chain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    H, O, T, M, B = SHAPES[case]
    ref64 = _operands(H, O, T, M, B, seed=T * M + B)
    args = [a.float().cuda() for a in ref64]
    before = tracing.LAUNCHES.copy()
    got = marginal_moments(*args)
    torch.cuda.synchronize()
    assert dict(tracing.LAUNCHES - before) == {"vargp_marginal_moments": 1}
    plain = marginal_moments_plain(*args)
    want = marginal_moments_plain(*ref64)
    for name, k, p, r in zip(("f_mean", "f_var"), got, plain, want):
        assert k.shape == (H, O, B) and bool(torch.isfinite(k).all())
        scale = float(r.abs().max())
        assert float((k - p).abs().max()) <= 1e-5 * max(scale, 1.0), name
        err_k = float((k.double().cpu() - r).abs().max())
        err_p = float((p.double().cpu() - r).abs().max())
        assert err_k <= 2.0 * err_p, (name, err_k, err_p)
