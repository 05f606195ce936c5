"""K6: fused Cholesky factor and lower-triangular inverse of (..., S, S)
SPD matrices in one launch (``csrc/chol_inv.cu``).

Replaces ``vargp_tpu/ops/pallas/chol_inv.py::_chol_inv_call``.  A CUDA
tensor launches the kernel, one thread-block cluster per matrix; a CPU
tensor takes :func:`chol_inv_plain`: K7's panel algorithm, which also
inverts the diagonal blocks, then the off-diagonal row blocks
X[i, :i] = -D_i^-1 (L[i, :i] X[:i, :i]).  Only the lower triangle of K is
read; a non-positive pivot gives NaN.
"""

import torch

from vargp_tpu_torch.ops.cuda.build import on_cpu
from vargp_tpu_torch.ops.cuda.chol import blocked_plain, launch_clustered
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
    L, X = torch.empty_like(K), torch.empty_like(K)
    launch_clustered(chol_inv, "vargp_chol_inv", K, L, X)
    return L, X


chol_inv.launches = 0
