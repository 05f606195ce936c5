"""K3: batched lower Cholesky of 128x128 SPD blocks (``csrc/diag_chol.cu``).

Replaces ``vargp_tpu/ops/pallas/chol_panel.py::diag_chol_pallas_t``.  A
CUDA tensor launches the kernel; a CPU tensor takes
:func:`diag_chol_plain`.  Both give NaN from a non-positive pivot (no
clamp, no error swallowed), as the TPU kernel does.  The caller adds the
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


def diag_chol(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each (..., 128, 128) block."""
    if on_cpu(A):
        return diag_chol_plain(A)
    if A.shape[-2:] != (BS, BS):
        raise ValueError(f"diag_chol: blocks must be {BS}x{BS}, got {tuple(A.shape)}")
    check_f32_contiguous("diag_chol", A)
    G = A.numel() // (BS * BS)
    if G == 0:
        return torch.empty_like(A)
    out = torch.empty_like(A)
    launch("vargp_diag_chol", A.device, A.data_ptr(), out.data_ptr(), G)
    diag_chol.launches += 1
    return out


diag_chol.launches = 0
