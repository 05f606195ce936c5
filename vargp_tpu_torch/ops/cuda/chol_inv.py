"""K6: fused Cholesky factor and lower-triangular inverse of (..., S, S)
SPD matrices in one launch (``csrc/chol_inv.cu``).

Replaces ``vargp_tpu/ops/pallas/chol_inv.py::_chol_inv_call``.  A CUDA
tensor launches the kernel; a CPU tensor takes :func:`chol_inv_plain`:
K7's panel algorithm, the diagonal blocks' inverses by substitution, then
the off-diagonal row blocks X[i, :i] = -D_i^-1 (L[i, :i] X[:i, :i]).
Only the lower triangle of K is read; a non-positive pivot gives NaN.
"""

import torch

from vargp_tpu_torch.ops.cuda.build import check_f32_contiguous, launch, on_cpu
from vargp_tpu_torch.ops.cuda.chol import blocked_plain
from vargp_tpu_torch.ops.cuda.diag_chol import BS


def chol_inv_plain(K: torch.Tensor):
    """(L, L^-1) of each (..., S, S) matrix."""
    S = K.shape[-1]
    L, dinvs = blocked_plain(K)
    X = torch.zeros_like(L)
    for i, Dinv in enumerate(dinvs):
        r0, r1 = i * BS, min((i + 1) * BS, S)
        X[..., r0:r1, r0:r1] = Dinv
        if i:
            P = torch.matmul(L[..., r0:r1, :r0], X[..., :r0, :r0])
            X[..., r0:r1, :r0] = -torch.matmul(Dinv, P)
    return L, X


def chol_inv(K: torch.Tensor):
    """(chol(K), chol(K)^-1) of each (..., S, S) SPD matrix, through K6."""
    if on_cpu(K):
        return chol_inv_plain(K)
    S = K.shape[-1]
    if K.dim() < 2 or K.shape[-2] != S:
        raise ValueError(f"chol_inv: square matrices expected, got {tuple(K.shape)}")
    check_f32_contiguous("chol_inv", K)
    G = K.numel() // max(S * S, 1)
    L, X = torch.empty_like(K), torch.empty_like(K)
    if G and S:
        launch("vargp_chol_inv", K.device, K.data_ptr(), L.data_ptr(), X.data_ptr(), G, S)
        chol_inv.launches += 1
    return L, X


chol_inv.launches = 0
