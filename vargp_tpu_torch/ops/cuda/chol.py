"""K7: batched dense lower Cholesky of (..., S, S) SPD matrices
(``csrc/chol.cu``).

Replaces ``vargp_tpu/ops/pallas/chol.py::cholesky_pallas``.  The operator
``vargp_torch::cholesky`` launches the kernel for a CUDA tensor, one
thread-block cluster per matrix, and takes :func:`cholesky_plain` for a
CPU tensor: the same right-looking panel algorithm in PyTorch ops, step
for step.  Only the lower triangle of K is read; a
non-positive pivot gives NaN, as the TPU kernel does.  The caller adds the
jitter.
"""

import torch

from vargp_tpu_torch.ops.cuda.build import (check_f32_contiguous, kernel_op, launch, on_card,
                                            on_cpu)
from vargp_tpu_torch.ops.cuda.diag_chol import BS, chol_cost, diag_chol_plain

CHUNK = 32  # the kernel's column chunk inside a diagonal block
MAX_CLUSTER = 8  # the portable thread-block cluster size


def cluster_size(G: int, n_sm: int) -> int:
    """Blocks per matrix: the largest power of two <= min(8, n_sm // G),
    and at least 1 (4 at G = 30 on 132 SMs, 8 at G <= 16, 1 at G >= 67)."""
    cap = min(MAX_CLUSTER, n_sm // max(G, 1))
    c = 1
    while 2 * c <= cap:
        c *= 2
    return c


def tri_inv_plain(L: torch.Tensor) -> torch.Tensor:
    """Inverse of each lower-triangular (..., n, n) block by forward
    substitution, row by row on the lower triangle:
    X[i, :i+1] = (e_i - L[i, :i] X[:i, :i+1]) / L[i, i]; the strict upper
    triangle stays 0, as in the kernel, whatever NaN a failed factor holds.
    Like the kernel, it multiplies by each pivot's reciprocal."""
    n = L.shape[-1]
    X = torch.zeros_like(L)
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    for i in range(n):
        s = eye[i, :i + 1] - torch.matmul(L[..., i:i + 1, :i], X[..., :i, :i + 1])[..., 0, :]
        X[..., i, :i + 1] = s * (1.0 / L[..., i, i:i + 1])
    return X


def diag_step_plain(A: torch.Tensor, matmul=torch.matmul):
    """The kernel's diagonal step on (..., n, n) blocks, n a multiple of 32
    (lower triangle read): (L, L^-1).  Per 32-column chunk: the chunk's
    32 x 32 block by a column loop, the rows below it by substitution
    against that block, then the rank-32 update of the trailing lower
    triangle as a product.  The inverse blockwise: each chunk's 32 x 32
    inverse by substitution, then the off-diagonal 32-blocks nearest the
    diagonal first, X[i, j] = -X[i, i] (L[i, j:i] X[j:i, j]), as products.
    ``matmul`` computes every product (the kernel's tensor-core tiles)."""
    n = A.shape[-1]
    A = torch.tril(A)
    for c0 in range(0, n, CHUNK):
        c1 = c0 + CHUNK
        L11 = diag_chol_plain(A[..., c0:c1, c0:c1])
        A[..., c0:c1, c0:c1] = L11
        if c1 == n:
            break
        X = A[..., c1:, c0:c1].clone()
        for j in range(CHUNK):
            X[..., :, j] = X[..., :, j] * (1.0 / L11[..., j, j, None])
            X[..., :, j + 1:] -= X[..., :, j:j + 1] * L11[..., j + 1:, j].unsqueeze(-2)
        A[..., c1:, c0:c1] = X
        A[..., c1:, c1:] -= torch.tril(matmul(X, X.transpose(-1, -2)))
    Linv = torch.zeros_like(A)
    nch = n // CHUNK
    blk = lambda i: slice(i * CHUNK, (i + 1) * CHUNK)
    for q in range(nch):
        Linv[..., blk(q), blk(q)] = tri_inv_plain(A[..., blk(q), blk(q)])
    for d in range(1, nch):
        for i in range(d, nch):
            j = i - d
            T = matmul(A[..., blk(i), j * CHUNK:i * CHUNK], Linv[..., j * CHUNK:i * CHUNK, blk(j)])
            Linv[..., blk(i), blk(j)] = -matmul(Linv[..., blk(i), blk(i)], T)
    return A, Linv


def blocked_plain(K: torch.Tensor, matmul=torch.matmul):
    """The kernel's panel algorithm: per 128-column panel, the diagonal
    step (:func:`diag_step_plain`; a ragged last block padded with the
    identity, as the kernel masks it in shared memory), the panel below as
    a product with the diagonal block's inverse, then the trailing update
    by L21 L21^T.  ``matmul`` computes the products (the CPU tests pass an
    emulation of the kernel's 3xTF32 arithmetic).  Returns (L, the
    diagonal blocks' inverses in panel order)."""
    S = K.shape[-1]
    A = torch.tril(K)
    L = torch.zeros_like(A)
    eye = torch.eye(BS, dtype=K.dtype, device=K.device)
    dinvs = []
    for kc in range(0, S, BS):
        r0 = min(kc + BS, S)
        w = r0 - kc
        D = eye.expand(*K.shape[:-2], BS, BS).clone()
        D[..., :w, :w] = A[..., kc:r0, kc:r0]
        Ld, Dinv = (t[..., :w, :w] for t in diag_step_plain(D, matmul))
        dinvs.append(Dinv)
        L[..., kc:r0, kc:r0] = Ld
        if r0 < S:
            L21 = matmul(A[..., r0:, kc:r0], Dinv.transpose(-1, -2))
            L[..., r0:, kc:r0] = L21
            A[..., r0:, r0:] -= torch.tril(matmul(L21, L21.transpose(-1, -2)))
    return L, dinvs


def cholesky_plain(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each (..., S, S) matrix."""
    return blocked_plain(K)[0]


def check_square(name: str, K: torch.Tensor) -> None:
    """K6's and K7's checks: square matrices on every device; contiguous
    float32 on the card."""
    S = K.shape[-1]
    if K.dim() < 2 or K.shape[-2] != S:
        raise ValueError(f"{name}: square matrices expected, got {tuple(K.shape)}")
    if on_card(K):
        check_f32_contiguous(name, K)


def launch_clustered(wrapper, symbol: str, K: torch.Tensor, *outs: torch.Tensor) -> int:
    """Launch K7's or K6's kernel on (G, S, S) matrices with one cluster of
    :func:`cluster_size` blocks per matrix; returns the cluster size."""
    S = K.shape[-1]
    check_square(wrapper.__name__, K)
    if K.data_ptr() % 16:  # cp.async reads 16-byte rows
        K = K.clone()
    G = K.numel() // max(S * S, 1)
    C = cluster_size(G, torch.cuda.get_device_properties(K.device).multi_processor_count)
    if G and S:
        launch(symbol, K.device, K.data_ptr(), *(o.data_ptr() for o in outs), G, S, C)
    return C


def _cpu(K):
    check_square("cholesky", K)
    return cholesky_plain(K)


def _cuda(K):
    L = torch.empty_like(K)
    launch_clustered(cholesky, "vargp_chol", K, L)
    return L


def _fake(K):
    on_cpu(K)  # refuses a meta tensor
    check_square("cholesky", K)
    return torch.empty_like(K)


def cost(K):
    """K's factor (:func:`chol_cost`) on the tensor cores in 3xTF32."""
    return chol_cost(K, precision="3xtf32")


cholesky_op = kernel_op("cholesky", "(Tensor K) -> Tensor", cpu=_cpu, cuda=_cuda, fake=_fake,
                        cost=cost)


def cholesky(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each (..., S, S) SPD matrix, through K7."""
    return cholesky_op(K)

