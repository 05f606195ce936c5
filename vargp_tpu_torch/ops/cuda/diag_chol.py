"""K3 and K8: batched lower Cholesky of SPD diagonal blocks up to 128 wide.

K3 (``csrc/diag_chol.cu``, :func:`diag_chol`) replaces
``vargp_tpu/ops/pallas/chol_panel.py::diag_chol_pallas_t``; K8
(``csrc/diag_chol_chunked.cu``, :func:`diag_chol_chunked`) replaces
``diag_chol_pallas`` of the same file, the chunked design of the same
function (one entry for both of its TPU bodies: no ``unrolled`` flag).
K3 takes (..., h, h) blocks with h <= 128 as views, read in place: the
identity padding that the JAX package adds around its kernel happens in
shared memory.  The operators ``vargp_torch::diag_chol`` and
``vargp_torch::diag_chol_chunked`` launch the kernels for CUDA tensors;
for CPU tensors they take :func:`diag_chol_plain` on the h x h block
itself, which gives bitwise the leading block of the factor of the
identity-padded 128-block (the column loop's leading entries never read
the tail).  All give NaN from a
non-positive pivot (no clamp, no error swallowed), as the TPU kernels do,
and read only the lower triangle.  The caller adds the jitter.
"""

import math

import torch

from vargp_tpu_torch.ops.cuda.build import (Cost, check_f32_contiguous, kernel_op, launch,
                                            on_card, on_cpu)

BS = 128  # the widest block the kernels factor


def diag_chol_plain(A: torch.Tensor) -> torch.Tensor:
    """Column loop over (..., n, n) with the kernel's arithmetic:
    l = A[:, j] * rsqrt(A[j, j]) on rows >= j, then A -= l l^T on the
    trailing rows and columns."""
    n = A.shape[-1]
    A = A.clone()
    L = torch.zeros_like(A)
    idx = torch.arange(n, device=A.device)
    for j in range(n):
        r = torch.rsqrt(A[..., j, j])[..., None]
        col = torch.where(idx >= j, A[..., :, j] * r, 0.0)
        L[..., :, j] = col
        u = torch.where(idx > j, col, 0.0)
        A = A - u[..., :, None] * u[..., None, :]
    return L


def batch_stride(A: torch.Tensor) -> int:
    """The one stride between consecutive blocks of A's flattened batch
    dimensions (0 for fewer than two blocks); raises when they do not
    flatten to one."""
    stride, span = 0, None
    if A.numel() == 0:
        return stride
    for size, s in zip(reversed(A.shape[:-2]), reversed(A.stride()[:-2])):
        if size == 1:
            continue
        if span is not None and s != span:
            raise ValueError(
                f"diag_chol: batch dimensions {tuple(A.shape[:-2])} with strides "
                f"{A.stride()[:-2]} do not flatten to one stride")
        if span is None:
            stride = s
        span = s * size
    return stride


def _check_blocks(A: torch.Tensor) -> int:
    """K3's checks of shape and strides, on every device (and float32 on
    the card); returns the batch stride."""
    h = A.shape[-1]
    if A.dim() < 2 or A.shape[-2] != h or h > BS:
        raise ValueError(f"diag_chol: blocks must be square and at most {BS} wide, "
                         f"got {tuple(A.shape)}")
    if h > 1 and A.stride(-1) != 1:
        raise ValueError(f"diag_chol: the last stride must be 1, got strides {A.stride()}")
    stride = batch_stride(A)
    if on_card(A) and A.dtype != torch.float32:
        raise ValueError(f"diag_chol: the kernel takes float32, got {A.dtype}")
    return stride


def chol_cost(A, n_out: int = 1, n_factor: int = 1, precision: str = "f32") -> Cost:
    """Factoring (..., h, h) blocks: h^3/3 multiply-adds' worth each
    (``n_factor`` times that for a factor and its inverse), the lower
    triangle read once and ``n_out`` h x h outputs written.  K3 and K8
    factor in f32 on the CUDA cores; K6 and K7 pass ``3xtf32``, their
    tensor-core tiles."""
    h, G = A[-1], math.prod(A[:-2])
    return Cost(n_factor * G * h ** 3 // 3, 4 * G * (h * (h + 1) // 2 + n_out * h * h), precision)


def _cpu(A):
    _check_blocks(A)
    return diag_chol_plain(A)


def _cuda(A):
    stride = _check_blocks(A)
    h = A.shape[-1]
    out = torch.empty(A.shape, dtype=A.dtype, device=A.device)
    G = out.numel() // (h * h) if h else 0
    if G:
        launch("vargp_diag_chol", A.device, A.data_ptr(), out.data_ptr(), G, stride,
               A.stride(-2), h)
    return out


def _fake(A):
    on_cpu(A)  # refuses a meta tensor
    _check_blocks(A)
    return A.new_empty(A.shape)


diag_chol_op = kernel_op("diag_chol", "(Tensor A) -> Tensor", cpu=_cpu, cuda=_cuda, fake=_fake,
                         cost=chol_cost)


def diag_chol(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each (..., h, h) block (h <= 128), through
    K3.  ``A`` may be a view: its last stride must be 1 and its batch
    dimensions must flatten to one stride.  Returns a new contiguous
    tensor."""
    return diag_chol_op(A)


def _check_chunked(A: torch.Tensor) -> None:
    """K8's checks: 128 x 128 blocks on every device; contiguous float32 on
    the card."""
    if A.dim() < 2 or A.shape[-2:] != (BS, BS):
        raise ValueError(f"diag_chol_chunked: blocks must be {BS}x{BS}, got {tuple(A.shape)}")
    if on_card(A):
        check_f32_contiguous("diag_chol_chunked", A)


def _cpu_chunked(A):
    _check_chunked(A)
    return diag_chol_plain(A)


def _cuda_chunked(A):
    _check_chunked(A)
    G = A.numel() // (BS * BS)
    out = torch.empty_like(A)
    if G:
        launch("vargp_diag_chol_chunked", A.device, A.data_ptr(), out.data_ptr(), G)
    return out


def _fake_chunked(A):
    on_cpu(A)  # refuses a meta tensor
    _check_chunked(A)
    return torch.empty_like(A)


diag_chol_chunked_op = kernel_op("diag_chol_chunked", "(Tensor A) -> Tensor", cpu=_cpu_chunked,
                                 cuda=_cuda_chunked, fake=_fake_chunked, cost=chol_cost)


def diag_chol_chunked(A: torch.Tensor) -> torch.Tensor:
    """The same factor of contiguous (..., 128, 128) blocks through K8,
    which reads only the lower triangle."""
    return diag_chol_chunked_op(A)

