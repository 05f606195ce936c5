"""K3 and K8: batched lower Cholesky of 128x128 SPD blocks.

K3 (``csrc/diag_chol.cu``, :func:`diag_chol`) replaces
``vargp_tpu/ops/pallas/chol_panel.py::diag_chol_pallas_t``; K8
(``csrc/diag_chol_chunked.cu``, :func:`diag_chol_chunked`) replaces
``diag_chol_pallas`` of the same file, the chunked design of the same
function (one entry for both of its TPU bodies: no ``unrolled`` flag).
A CUDA tensor launches the kernel; a CPU tensor takes
:func:`diag_chol_plain`.  All give NaN from a non-positive pivot (no
clamp, no error swallowed), as the TPU kernels do.  The caller adds the
jitter and pads smaller blocks with an identity tail.
"""

import torch

from vargp_tpu_torch.ops.cuda.build import check_f32_contiguous, launch, on_cpu

BS = 128  # the block size the kernel factors


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


def _launch_blocks(wrapper, symbol: str, A: torch.Tensor) -> torch.Tensor:
    if A.shape[-2:] != (BS, BS):
        raise ValueError(f"{wrapper.__name__}: blocks must be {BS}x{BS}, got {tuple(A.shape)}")
    check_f32_contiguous(wrapper.__name__, A)
    G = A.numel() // (BS * BS)
    out = torch.empty_like(A)
    if G:
        launch(symbol, A.device, A.data_ptr(), out.data_ptr(), G)
        wrapper.launches += 1
    return out


def diag_chol(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each (..., 128, 128) block, through K3."""
    if on_cpu(A):
        return diag_chol_plain(A)
    return _launch_blocks(diag_chol, "vargp_diag_chol", A)


def diag_chol_chunked(A: torch.Tensor) -> torch.Tensor:
    """The same factor through K8, which reads only the lower triangle."""
    if on_cpu(A):
        return diag_chol_plain(A)
    return _launch_blocks(diag_chol_chunked, "vargp_diag_chol_chunked", A)


diag_chol.launches = 0
diag_chol_chunked.launches = 0
