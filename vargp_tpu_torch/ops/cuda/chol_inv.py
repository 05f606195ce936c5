"""K6: fused Cholesky factor and lower-triangular inverse of (..., S, S)
SPD matrices in one launch (``csrc/chol_inv.cu``).

Replaces ``vargp_tpu/ops/pallas/chol_inv.py::_chol_inv_call``.  The
operator ``vargp_torch::chol_inv`` launches the kernel for a CUDA tensor,
one thread-block cluster per matrix, and takes :func:`chol_inv_plain` for
a CPU tensor: K7's panel algorithm, which also inverts the diagonal
blocks, then the off-diagonal row blocks
X[i, :i] = -D_i^-1 (L[i, :i] X[:i, :i]).  Only the lower triangle of K is
read; a non-positive pivot gives NaN.
"""

import torch

from vargp_tpu_torch.ops.cuda.build import kernel_op, on_cpu
from vargp_tpu_torch.ops.cuda.chol import blocked_plain, check_square, launch_clustered
from vargp_tpu_torch.ops.cuda.diag_chol import BS, chol_cost


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


def cost(K):
    """Twice K7's work (the factor and its inverse) in 3xTF32, the lower
    triangle read once, L and L^-1 written."""
    return chol_cost(K, n_out=2, n_factor=2, precision="3xtf32")


def _cpu(K):
    check_square("chol_inv", K)
    return chol_inv_plain(K)


def _cuda(K):
    L, X = torch.empty_like(K), torch.empty_like(K)
    launch_clustered(chol_inv, "vargp_chol_inv", K, L, X)
    return L, X


def _fake(K):
    on_cpu(K)  # refuses a meta tensor
    check_square("chol_inv", K)
    return torch.empty_like(K), torch.empty_like(K)


chol_inv_op = kernel_op("chol_inv", "(Tensor K) -> (Tensor, Tensor)", cpu=_cpu, cuda=_cuda,
                        fake=_fake, cost=cost)


def chol_inv(K: torch.Tensor):
    """(chol(K), chol(K)^-1) of each (..., S, S) SPD matrix, through K6."""
    return chol_inv_op(K)

