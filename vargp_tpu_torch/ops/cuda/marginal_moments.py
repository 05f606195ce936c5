"""marginal_moments: the predictive marginal's readers of W in one pass
(``csrc/marginal_moments.cu``): f_mean = v^T W and
f_var = max(Kxx - diag(W^T W) + diag(C^T C), 0), C_t = w_t^T W_t.

Replaces no Pallas kernel: the JAX package leaves these readers to XLA.
The kernel reads W once and keeps C, W^2 and C^2 out of device memory; it
multiplies in f32 FMAs and only the entries on and below each w_t's diagonal.
Its tensor copies read rows of whole 16-byte groups from aligned bases: a W
or w whose rows are not (B, resp. M, no multiple of 4) goes in as a
zero-padded copy.
The operator ``vargp_torch::marginal_moments`` launches it for CUDA
tensors and takes :func:`marginal_moments_plain`, the chain of PyTorch
calls the marginal has always made, for CPU tensors; the two compute the
same function wherever every w_t is lower triangular (every w the factored
posterior gives: inv(L_tt) u_tril_t).
"""


import torch

from vargp_tpu_torch.ops.cuda.build import (Cost, check_f32_contiguous, kernel_op, launch,
                                            on_card, on_cpu, result_dtype)

MAX_M = 128  # the kernel's largest task block (csrc/marginal_moments.cu: kMaxM)
_BN = 64  # the kernel's columns a block
_GRID_MAX = 2 ** 31 - 1  # blocks in the kernel's one-dimensional grid


def marginal_moments_plain(W, v, w, kxx):
    """W (..., S, B), v (..., S, 1), w (..., T, M, M) with S = T M, kxx
    broadcasting against (..., B) -> f_mean, f_var (..., B): the dense
    products, squares and sums, in this order."""
    T, M = w.shape[-3], w.shape[-1]
    f_mean = torch.einsum("...mi,...mb->...b", v, W)
    diag1 = torch.sum(torch.square(W), dim=-2)
    W4 = W.reshape(*W.shape[:-2], T, M, W.shape[-1])
    C = torch.matmul(w.transpose(-1, -2), W4)  # (..., T, M, B)
    diag2 = torch.sum(torch.square(C), dim=(-3, -2))
    # exact value >= diag2 >= 0; the clamp only removes rounding below 0
    f_var = torch.clamp(kxx - diag1 + diag2, min=0.0)
    return f_mean, f_var


def _check(W, v, w, kxx) -> tuple:
    """Shapes on every device; on the card contiguous float32, M within the
    kernel's shared memory and the grid's limit.  Returns the outputs'
    shape (H, O, B)."""
    ok = W.dim() == 4 and w.dim() == 5 and kxx.dim() == 3
    if ok:
        H, O, S, B = W.shape
        T, M = w.shape[2], w.shape[-1]
        ok = (tuple(v.shape) == (H, O, S, 1) and tuple(w.shape) == (H, O, T, M, M)
              and T * M == S and tuple(kxx.shape) == (H, 1, 1))
    if not ok:
        raise ValueError(
            f"marginal_moments: W {tuple(W.shape)}, v {tuple(v.shape)}, w {tuple(w.shape)}, "
            f"kxx {tuple(kxx.shape)}: expected W (H, O, S, B), v (H, O, S, 1), "
            "w (H, O, T, M, M) with S = T M, kxx (H, 1, 1)"
        )
    if on_card(W):
        check_f32_contiguous("marginal_moments", W, v, w, kxx)
        if M > MAX_M:
            raise ValueError(
                f"marginal_moments: task blocks of {M} rows exceed the kernel's {MAX_M}")
        blocks = H * O * -(-B // _BN)
        if blocks > _GRID_MAX:
            raise ValueError(f"marginal_moments: {blocks} strips exceed the grid's limit")
    return (H, O, B)


def cost(W, v, w, kxx) -> Cost:
    """A matrix's operations: f_mean and diag1 2 S B each, C's triangle
    T M (M + 1) B (each C_t[m, b] a sum over k >= m), diag2's squares 2 S B
    and the tail 2 B, billed at the 3xTF32 rate, the card's fastest for
    f32-accurate products (the kernel itself uses f32 FMAs); W, v, w's
    lower triangles and kxx read once, f_mean and f_var written once."""
    H, O, S, B = W
    T, M = w[2], w[-1]
    G = H * O
    flops = G * B * (6 * S + T * M * (M + 1) + 2)
    nbytes = 4 * (G * S * B + G * S + G * T * (M * (M + 1) // 2) + H + 2 * G * B)
    return Cost(flops, nbytes, "3xtf32")


def _cpu(W, v, w, kxx):
    _check(W, v, w, kxx)
    return marginal_moments_plain(W, v, w, kxx)


def _rows_of_4(x: torch.Tensor) -> tuple:
    """x, or a zero-padded copy whose rows are a whole number of 16-byte
    groups from a 16-byte aligned base (the kernel's tensor copies need
    both), and that row stride."""
    n = x.shape[-1]
    ld = -(-n // 4) * 4
    if ld != n or x.data_ptr() % 16:
        padded = x.new_zeros((*x.shape[:-1], ld))
        padded[..., :n] = x
        x = padded
    return x, ld


def _cuda(W, v, w, kxx):
    H, O, B = _check(W, v, w, kxx)
    on_cpu(W, v, w, kxx)  # one device
    f_mean = torch.empty((H, O, B), device=W.device, dtype=torch.float32)
    f_var = torch.empty((H, O, B), device=W.device, dtype=torch.float32)
    T, M = w.shape[2], w.shape[-1]
    (W, ldW), (w, ldm) = _rows_of_4(W), _rows_of_4(w)
    launch("vargp_marginal_moments", W.device, W.data_ptr(), v.data_ptr(), w.data_ptr(),
           kxx.data_ptr(), f_mean.data_ptr(), f_var.data_ptr(), H * O, T, M, B, ldW, ldm, O)
    return f_mean, f_var


def _fake(W, v, w, kxx):
    on_cpu(W, v, w, kxx)  # refuses meta tensors and mixed devices
    shape = _check(W, v, w, kxx)
    dt = result_dtype(W, v, w, kxx)
    return W.new_empty(shape, dtype=dt), W.new_empty(shape, dtype=dt)


marginal_moments_op = kernel_op(
    "marginal_moments", "(Tensor W, Tensor v, Tensor w, Tensor kxx) -> (Tensor, Tensor)",
    cpu=_cpu, cuda=_cuda, fake=_fake, cost=cost)


def marginal_moments(W: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                     kxx: torch.Tensor) -> tuple:
    """(f_mean, f_var), each (H, O, B), of W (H, O, S, B), v (H, O, S, 1),
    lower-triangular w (H, O, T, M, M) with S = T M and kxx (H, 1, 1)."""
    return marginal_moments_op(W, v, w, kxx)
