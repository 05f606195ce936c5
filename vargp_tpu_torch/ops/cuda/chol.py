"""K7: batched dense lower Cholesky of (..., S, S) SPD matrices
(``csrc/chol.cu``).

Replaces ``vargp_tpu/ops/pallas/chol.py::cholesky_pallas``.  A CUDA tensor
launches the kernel; a CPU tensor takes :func:`cholesky_plain`, the same
right-looking panel algorithm in PyTorch ops.  Only the lower triangle of
K is read; a non-positive pivot gives NaN, as the TPU kernel does.  The
caller adds the jitter.
"""

import torch

from vargp_tpu_torch.ops.cuda.build import check_f32_contiguous, launch, on_cpu
from vargp_tpu_torch.ops.cuda.diag_chol import BS, diag_chol_plain


def tri_inv_plain(L: torch.Tensor) -> torch.Tensor:
    """Inverse of each lower-triangular (..., n, n) block by forward
    substitution, row by row on the lower triangle:
    X[i, :i+1] = (e_i - L[i, :i] X[:i, :i+1]) / L[i, i]; the strict upper
    triangle stays 0, as in the kernel, whatever NaN a failed factor holds."""
    n = L.shape[-1]
    X = torch.zeros_like(L)
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    for i in range(n):
        s = eye[i, :i + 1] - torch.matmul(L[..., i:i + 1, :i], X[..., :i, :i + 1])[..., 0, :]
        X[..., i, :i + 1] = s / L[..., i, i:i + 1]
    return X


def blocked_plain(K: torch.Tensor):
    """The kernel's panel algorithm: per 128-column panel, the diagonal
    block's factor (a column loop) and its inverse, the panel below as a
    product with that inverse, then the trailing update by L21 L21^T.
    Returns (L, the diagonal blocks' inverses in panel order)."""
    S = K.shape[-1]
    A = torch.tril(K)
    L = torch.zeros_like(A)
    dinvs = []
    for kc in range(0, S, BS):
        r0 = min(kc + BS, S)
        Ld = diag_chol_plain(A[..., kc:r0, kc:r0])
        Dinv = tri_inv_plain(Ld)
        dinvs.append(Dinv)
        L[..., kc:r0, kc:r0] = Ld
        if r0 < S:
            L21 = torch.matmul(A[..., r0:, kc:r0], Dinv.transpose(-1, -2))
            L[..., r0:, kc:r0] = L21
            A[..., r0:, r0:] -= torch.tril(torch.matmul(L21, L21.transpose(-1, -2)))
    return L, dinvs


def cholesky_plain(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each (..., S, S) matrix."""
    return blocked_plain(K)[0]


def cholesky(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each (..., S, S) SPD matrix, through K7."""
    if on_cpu(K):
        return cholesky_plain(K)
    S = K.shape[-1]
    if K.dim() < 2 or K.shape[-2] != S:
        raise ValueError(f"cholesky: square matrices expected, got {tuple(K.shape)}")
    check_f32_contiguous("cholesky", K)
    G = K.numel() // max(S * S, 1)
    L = torch.empty_like(K)
    if G and S:
        launch("vargp_chol", K.device, K.data_ptr(), L.data_ptr(), G, S)
        cholesky.launches += 1
    return L


cholesky.launches = 0
