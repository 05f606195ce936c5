"""Batched dense linear algebra for the sparse-GP math.

Counterpart of ``vargp_tpu/gpmath/linalg.py``.  Every product is a plain
f32 ``torch.matmul``: ``vargp_tpu_torch`` turns TF32 off at import, so
these run at the JAX package's "highest" precision.  The JAX package's
"high" (bf16x3) products ``mm_h`` / ``mtm_h`` are f32 here too, which is
at least as accurate.  Their gradients are autograd's, in f32: the JAX
package's hand rules for them (``_dot_fb``, ``_dot_hh``) only choose the
backward's precision.  The factorisation below is differentiated as a
whole by ``ops.dispatch.chol_and_inv``'s rule, never through its parts;
``cholesky`` by ``ops.dispatch.batched_cholesky``'s.  ``tri_solve`` is
``torch.linalg.solve_triangular``: the JAX package leaves it to XLA,
outside any Pallas kernel.
"""

import torch
import torch.nn.functional as F

from vargp_tpu_torch.ops.cuda.diag_chol import BS, diag_chol

DEFAULT_JITTER = 1e-4
_TRI_INV_BLOCK = 128


def add_jitter(K: torch.Tensor, eps: float = DEFAULT_JITTER) -> torch.Tensor:
    """K + eps*I on the trailing two dims."""
    return K + eps * torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)


def cholesky(K: torch.Tensor, eps: float = DEFAULT_JITTER) -> torch.Tensor:
    """Lower Cholesky factor of K + eps*I, through ``ops.dispatch``'s K7."""
    from vargp_tpu_torch.ops.dispatch import batched_cholesky

    return batched_cholesky(add_jitter(K, eps))


def sym_cholesky(K: torch.Tensor, eps: float = DEFAULT_JITTER) -> torch.Tensor:
    """chol(sym(K) + eps*I) through K7, sym(K) = (K + K^T) / 2: the value
    and gradient of ``jnp.linalg.cholesky``, which symmetrises its input
    where K7 reads only the lower triangle.  For a K symmetric only to
    rounding (a conditional covariance, a Gram's plain version)."""
    return cholesky(0.5 * (K + K.transpose(-1, -2)), eps)


def rev_cholesky(L: torch.Tensor) -> torch.Tensor:
    """L @ L^T."""
    return torch.matmul(L, L.transpose(-1, -2))


def tri_solve(L: torch.Tensor, B: torch.Tensor, *, transpose: bool = False) -> torch.Tensor:
    """Solve L X = B (or L^T X = B) with L lower-triangular, broadcasting
    the leading (batch) dims of L and B against each other."""
    batch = torch.broadcast_shapes(L.shape[:-2], B.shape[:-2])
    L = torch.broadcast_to(L, (*batch, *L.shape[-2:]))
    B = torch.broadcast_to(B, (*batch, *B.shape[-2:]))
    if transpose:
        return torch.linalg.solve_triangular(L.transpose(-1, -2), B, upper=True)
    return torch.linalg.solve_triangular(L, B, upper=False)


def chol_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) X = B given the lower Cholesky factor L."""
    return tri_solve(L, tri_solve(L, B), transpose=True)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b."""
    return torch.matmul(a, b)


def mtm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T @ b."""
    return torch.matmul(a.transpose(-1, -2), b)


def mmt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b^T."""
    return torch.matmul(a, b.transpose(-1, -2))


mm_h = mm
mtm_h = mtm


def _tri_inv_newton(L: torch.Tensor) -> torch.Tensor:
    """Exact lower-triangular inverse by Newton-Schulz, pure matmuls.

    With X0 = diag(L)^{-1} the residual I - L X0 is strictly lower
    triangular, hence nilpotent, and X <- X (2I - L X) squares it: after
    ceil(log2 n) steps the inverse is exact up to rounding."""
    n = L.shape[-1]
    steps = max(1, (n - 1).bit_length())
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    X = eye / torch.diagonal(L, dim1=-2, dim2=-1)[..., :, None]
    two_eye = 2.0 * eye
    for _ in range(steps):
        X = mm(X, two_eye - mm(L, X))
    return X


def pad_identity_tail(A: torch.Tensor, Sp: int) -> torch.Tensor:
    """Pad ``... x S x S`` to ``... x Sp x Sp`` with an identity tail: the
    Cholesky factor and triangular inverse of blockdiag(A, I) are
    blockdiag(op(A), I), so slicing the leading block back is exact."""
    S = A.shape[-1]
    tail = torch.cat([
        torch.zeros(S, dtype=A.dtype, device=A.device),
        torch.ones(Sp - S, dtype=A.dtype, device=A.device),
    ])
    return F.pad(A, (0, Sp - S, 0, Sp - S)) + torch.diag(tail)


def _diag_chol(A: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky of (..., S, S) diagonal blocks.

    S <= 128 goes through K3, which reads the view in place (the identity
    padding to 128 happens inside the kernel); above that, as in the JAX
    package, through the library factorisation."""
    if A.shape[-1] > BS:
        return torch.linalg.cholesky(A)
    return diag_chol(A)


def _tri_inv_rows(L, dinv_of, nb: int, block: int, Sp: int):
    """Row-block assembly of a block-lower-triangular inverse:

        X[i,i] = dinv_i;   X[i,:i] = -dinv_i (sum_j L[i,j] X[j,:i])

    ``dinv_of(i)`` returns inv(L[i,i])."""
    batch = L.shape[:-2]

    def full_row(i, row_left):
        r1 = (i + 1) * block
        parts = ([row_left] if i else []) + [dinv_of(i)]
        if Sp - r1:
            parts.append(L.new_zeros((*batch, block, Sp - r1)))
        return torch.cat(parts, dim=-1)

    rows = [full_row(0, None)]
    for i in range(1, nb):
        r0, r1 = i * block, (i + 1) * block
        acc = None
        for j in range(i):
            contrib = mm(L[..., r0:r1, j * block:(j + 1) * block], rows[j][..., :r0])
            acc = contrib if acc is None else acc + contrib
        rows.append(full_row(i, -mm(dinv_of(i), acc)))
    return torch.cat(rows, dim=-2)


def chol_and_inv_blocked(K: torch.Tensor, block_m: int):
    """Blocked Cholesky and triangular inverse with a known block size:
    T diagonal-block factorisations (K3) glued by matmuls.  Returns
    (L, L^{-1})."""
    S = K.shape[-1]
    if S % block_m:
        raise ValueError(f"block {block_m} does not divide {S}")
    T = S // block_m
    if T == 1:
        L = _diag_chol(K)
        return L, _tri_inv_newton(L)

    batch = K.shape[:-2]
    A = K  # trailing submatrix, shrinking by block_m per step
    cols, dinvs = [], []
    for t in range(T):
        Ld = _diag_chol(A[..., :block_m, :block_m])
        Dinv = _tri_inv_newton(Ld)
        dinvs.append(Dinv)
        if t + 1 < T:
            Lcol = mmt(A[..., block_m:, :block_m], Dinv)  # C Ld^{-T}
            cols.append(torch.cat([Ld, Lcol], dim=-2))
            A = A[..., block_m:, block_m:] - mmt(Lcol, Lcol)
        else:
            cols.append(Ld)

    def pad_col(c, t):
        if not t:
            return c
        return torch.cat([K.new_zeros((*batch, t * block_m, block_m)), c], dim=-2)

    L = torch.cat([pad_col(c, t) for t, c in enumerate(cols)], dim=-1)
    X = _tri_inv_rows(L, lambda t: dinvs[t], T, block_m, S)
    return L, X


def tri_inv(L: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of a batched lower-triangular matrix: Newton-Schulz
    on 128-row diagonal blocks, matmul row assembly for the rest."""
    block = _TRI_INV_BLOCK
    S = L.shape[-1]
    if S <= block:
        return _tri_inv_newton(L)
    nb = -(-S // block)
    Sp = nb * block
    if Sp != S:
        L = pad_identity_tail(L, Sp)
    diag_blocks = torch.stack(
        [L[..., i * block:(i + 1) * block, i * block:(i + 1) * block]
         for i in range(nb)]
    )
    dinv = _tri_inv_newton(diag_blocks)
    X = _tri_inv_rows(L, lambda i: dinv[i], nb, block, Sp)
    return X[..., :S, :S]


def tri_half_split(k: int) -> int | None:
    """Multiple-of-128 halfway split for block-triangular matmul skipping,
    or None below k = 512 (vargp_tpu/gpmath/linalg.py:307)."""
    if k < 512:
        return None
    h = max(128, round(k / 256) * 128)
    return h if k - h >= 128 else None
