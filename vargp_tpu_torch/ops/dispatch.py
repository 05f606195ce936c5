"""Kernel dispatch: the generic RBF Gram and the Gram factorisations, each
with its backward rule, and the pairwise squared distance (``sq_dist``,
plain PyTorch, as in the JAX package).

Counterpart of ``vargp_tpu/ops/dispatch.py``.  Dispatch is by the
tensors' device: the kernel wrappers in ``ops.cuda`` launch their kernels
for CUDA tensors and run their plain versions for CPU tensors.  One JAX
knob is taken over, read at each call with the JAX package's loud-fail
contract (an unknown value raises): ``VARGP_TPU_CHOLINV`` = ``xla``
(default: the blocked factorisation, K3 on the diagonal blocks glued by
products) or ``pallas`` (the fused K6 for the whole batch).  The plain
Cholesky (``batched_cholesky``) always takes K7: the JAX package's
``VARGP_TPU_CHOLESKY`` only chose between XLA's factorisation and its
kernel.  The generic Gram is always f32 (K5): the JAX package's "high"
(bf16x3) option only chose a cheaper product on the TPU.
"""

import os

import torch

from vargp_tpu_torch.ops.cuda.chol import cholesky as _chol_kernel
from vargp_tpu_torch.ops.cuda.chol_inv import chol_inv as _chol_inv_kernel
from vargp_tpu_torch.ops.cuda.rbf_gram import SMALL_D
from vargp_tpu_torch.ops.cuda.rbf_gram import rbf_gram as _rbf_gram_kernel

# Blocked-split rule of vargp_tpu/ops/dispatch.py:185-214.  The upper bound
# is the diagonal-block kernel's: K3 takes blocks of at most 128 rows, as
# the Pallas backend has it.
_BLOCK_LO, _BLOCK_HI = 96, 128
_FACTOR_BLOCKED_ABOVE = 160  # the JAX package's _BLOCK_HI on other backends
_MAX_BLOCKS = 8
_PAD_WASTE_LIMIT = 0.15


def _env_choice(name: str, valid: tuple, default: str) -> str:
    """Read an environment knob; an unknown value raises rather than select
    another route (``_env_choice``, vargp_tpu/ops/dispatch.py:74-82)."""
    v = os.environ.get(name, default)
    if v not in valid:
        raise ValueError(f"{name}={v!r}: expected one of {valid}")
    return v


def _pick_block(S: int) -> int | None:
    """Divisor block of S in [96, 128] with 2..8 blocks, nearest 118."""
    best = None
    for T in range(2, _MAX_BLOCKS + 1):
        if S % T:
            continue
        d = S // T
        if _BLOCK_LO <= d <= _BLOCK_HI:
            score = abs(d - 118)
            if best is None or score < best[1]:
                best = (d, score)
    return best[0] if best else None


def _chol_and_inv_fwd(K: torch.Tensor):
    """(chol(K), chol(K)^{-1}) of a batch of SPD matrices (forward of
    ``_chol_and_inv_impl``): K6 for the whole batch under
    ``VARGP_TPU_CHOLINV=pallas``, else the blocked route."""
    if _env_choice("VARGP_TPU_CHOLINV", ("xla", "pallas"), "xla") == "pallas":
        return _chol_inv_kernel(K.contiguous())
    from vargp_tpu_torch.gpmath.linalg import (
        _diag_chol,
        chol_and_inv_blocked,
        pad_identity_tail,
        tri_inv,
    )

    S = K.shape[-1]
    if S > _FACTOR_BLOCKED_ABOVE:
        d = _pick_block(S)
        if d is not None:
            return chol_and_inv_blocked(K, d)
        # no friendly divisor: identity-pad to a multiple of 128 when the
        # waste is small (the leading S x S blocks slice back exactly)
        Sp = -(-S // 128) * 128
        if Sp // 128 <= _MAX_BLOCKS and (Sp - S) / S <= _PAD_WASTE_LIMIT:
            Lp, Xp = chol_and_inv_blocked(pad_identity_tail(K, Sp), 128)
            return Lp[..., :S, :S], Xp[..., :S, :S]
    L = _diag_chol(K)
    return L, tri_inv(L)


def _chol_bwd_dense(L, Linv, GL, Ginv):
    """Murray's Cholesky reverse rule with the solves as products with
    Linv (``_chol_and_inv_bwd``, vargp_tpu/ops/dispatch.py:346-373).  The
    cotangent of Linv joins through d(L^{-1}) = -L^{-1} dL L^{-1}; either
    cotangent may be None (its output unused)."""
    tril = torch.tril(torch.ones(L.shape[-2:], dtype=L.dtype, device=L.device))
    LinvT = Linv.transpose(-1, -2)
    if GL is None:
        GL = torch.zeros_like(L)
    if Ginv is not None:
        GL = GL - torch.matmul(torch.matmul(LinvT, Ginv), LinvT) * tril
    S = torch.matmul(L.transpose(-1, -2), GL)
    Phi = S * tril - 0.5 * torch.diag_embed(torch.diagonal(S, dim1=-2, dim2=-1))
    sym = Phi + Phi.transpose(-1, -2)
    return 0.5 * torch.matmul(torch.matmul(LinvT, sym), Linv)


def _chol_bwd_blocked(L, Linv, GL, Ginv, h: int):
    """The dense rule on a 2x2 block split at h (``_chol_bwd_blocked``,
    vargp_tpu/ops/dispatch.py:268-343).  Every operand is lower-triangular
    and each product reads only lower blocks, so the strictly upper blocks
    and one mirror of the symmetric result are skipped."""
    mm = torch.matmul

    def tn(a, b):  # a^T b
        return mm(a.transpose(-1, -2), b)

    def nt(a, b):  # a b^T
        return mm(a, b.transpose(-1, -2))

    def lower(b11, b21, b22):  # [[b11, 0], [b21, b22]]
        top = torch.cat([b11, b11.new_zeros((*b11.shape[:-1], S - h))], dim=-1)
        return torch.cat([top, torch.cat([b21, b22], dim=-1)], dim=-2)

    S = L.shape[-1]
    a1, a2, a3 = Linv[..., :h, :h], Linv[..., h:, :h], Linv[..., h:, h:]
    g1, g2, g3 = Ginv[..., :h, :h], Ginv[..., h:, :h], Ginv[..., h:, h:]

    # extra = -(Linv^T Ginv Linv^T); only its lower blocks survive the tril
    P11 = nt(g1, a1)
    P21 = nt(g2, a1)
    P22 = nt(g2, a2) + nt(g3, a3)
    E11 = tn(a1, P11) + tn(a2, P21)
    E21 = tn(a3, P21)
    E22 = tn(a3, P22)
    tril = torch.tril(torch.ones((S, S), dtype=L.dtype, device=L.device))
    B = GL - lower(E11, E21, E22) * tril

    # Phi needs only tril(L^T B)
    l1, l2, l3 = L[..., :h, :h], L[..., h:, :h], L[..., h:, h:]
    b1, b2, b3 = B[..., :h, :h], B[..., h:, :h], B[..., h:, h:]
    S11 = tn(l1, b1) + tn(l2, b2)
    S21 = tn(l3, b2)
    S22 = tn(l3, b3)
    Smat = lower(S11, S21, S22)
    Phi = Smat * tril - 0.5 * torch.diag_embed(torch.diagonal(Smat, dim1=-2, dim2=-1))
    sym = Phi + Phi.transpose(-1, -2)

    # K_bar = 0.5 Linv^T sym Linv is symmetric: its upper block is K21^T
    y1, y21, y3 = sym[..., :h, :h], sym[..., h:, :h], sym[..., h:, h:]
    Q11 = mm(y1, a1) + tn(y21, a2)
    Q21 = mm(y21, a1) + mm(y3, a2)
    Q22 = mm(y3, a3)
    K11 = tn(a1, Q11) + tn(a2, Q21)
    K21 = tn(a3, Q21)
    K22 = tn(a3, Q22)
    top = torch.cat([K11, K21.transpose(-1, -2)], dim=-1)
    return 0.5 * torch.cat([top, torch.cat([K21, K22], dim=-1)], dim=-2)


class _CholAndInv(torch.autograd.Function):
    """Forward: K3 on the diagonal blocks glued by products, or K6 under
    ``VARGP_TPU_CHOLINV=pallas`` (as the JAX package's ``_chol_inv_call``
    runs inside the same custom VJP).  Backward: the
    all-product rule on the saved (L, L^{-1}), split at ``tri_half_split``
    (S >= 512) as the JAX package's ``_tri_bwd_split`` does by default."""

    @staticmethod
    def forward(ctx, K):
        L, Linv = _chol_and_inv_fwd(K)
        ctx.save_for_backward(L, Linv)
        return L, Linv

    @staticmethod
    def backward(ctx, GL, Ginv):
        from vargp_tpu_torch.gpmath.linalg import tri_half_split

        L, Linv = ctx.saved_tensors
        h = tri_half_split(L.shape[-1])
        if h is not None:
            return _chol_bwd_blocked(L, Linv, GL, Ginv, h)
        return _chol_bwd_dense(L, Linv, GL, Ginv)


def chol_and_inv(K: torch.Tensor):
    """(chol(K), chol(K)^{-1}) of a batch of SPD matrices, differentiable
    through the JAX package's hand rule."""
    return _CholAndInv.apply(K)


class _CholAndInvFused(torch.autograd.Function):
    """Forward: K6.  Backward: the dense all-product rule on the saved
    (L, L^{-1}) (``chol_and_inv_pallas``'s ``_bwd``,
    vargp_tpu/ops/pallas/chol_inv.py:166-194)."""

    @staticmethod
    def forward(ctx, K):
        ctx.set_materialize_grads(False)
        L, Linv = _chol_inv_kernel(K.contiguous())
        ctx.save_for_backward(L, Linv)
        return L, Linv

    @staticmethod
    def backward(ctx, GL, Ginv):
        L, Linv = ctx.saved_tensors
        return _chol_bwd_dense(L, Linv, GL, Ginv)


def chol_and_inv_fused(K: torch.Tensor):
    """(chol(K), chol(K)^{-1}) through K6 whatever the knob says: the
    counterpart of ``chol_and_inv_pallas``."""
    return _CholAndInvFused.apply(K)


class _Cholesky(torch.autograd.Function):
    """Forward: K7.  Backward: Murray's rule with triangular solves,
    Phi = tril(L^T L_bar) with halved diagonal and
    K_bar = 1/2 L^{-T} (Phi + Phi^T) L^{-1}: the symmetric gradient that
    ``jnp.linalg.cholesky`` (which symmetrises its input) gives."""

    @staticmethod
    def forward(ctx, K):
        L = _chol_kernel(K.contiguous())
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, GL):
        (L,) = ctx.saved_tensors
        Lt = L.transpose(-1, -2)
        P = torch.tril(torch.matmul(Lt, GL))
        Phi = P - 0.5 * torch.diag_embed(torch.diagonal(P, dim1=-2, dim2=-1))
        sym = Phi + Phi.transpose(-1, -2)
        Y = torch.linalg.solve_triangular(Lt, sym, upper=True)  # L^{-T} sym
        return 0.5 * torch.linalg.solve_triangular(Lt, Y.transpose(-1, -2), upper=True).transpose(-1, -2)


def batched_cholesky(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of a batch of SPD matrices (jitter applied by
    the caller) through K7, differentiable."""
    return _Cholesky.apply(K)


class _RbfGram(torch.autograd.Function):
    """Forward: K5 on (G, M, D) x (G, N, D).  Backward: ``_rbf_gram_bwd``
    (vargp_tpu/ops/pallas/rbf_gram.py:152-171), products outside any
    kernel as in the JAX package.  With W = g K:
    dsx = W sy - rowsum(W) sx, dsy = W^T sx - colsum(W) sy and
    dgamma2 = sum(W) / max(gamma2, 1e-30).  Both inputs get a cotangent:
    under the deep kernel both sides are features of a trained map."""

    @staticmethod
    def forward(ctx, sx, sy, gamma2):
        K = _rbf_gram_kernel(sx, sy, gamma2)
        ctx.save_for_backward(sx, sy, gamma2, K)
        return K

    @staticmethod
    def backward(ctx, g):
        sx, sy, gamma2, K = ctx.saved_tensors
        W = g * K  # (G, M, N)
        if sx.shape[-1] <= SMALL_D:
            # the differences themselves, as the small kernel forms them:
            # W sy - rowsum(W) sx cancels where W is large and the rows close
            diff = sy[:, None, :, :] - sx[:, :, None, :]  # (G, M, N, D)
            dsx = torch.einsum("gmn,gmnd->gmd", W, diff)
            dsy = -torch.einsum("gmn,gmnd->gnd", W, diff)
        else:
            dsx = torch.matmul(W, sy) - torch.sum(W, dim=-1)[..., None] * sx
            dsy = torch.matmul(W.transpose(-1, -2), sx) - torch.sum(W, dim=-2)[..., None] * sy
        d_gamma2 = torch.sum(W, dim=(-2, -1)) / torch.clamp(gamma2, min=1e-30)
        return dsx, dsy, d_gamma2


def sq_dist(sx: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances |sx_i - sy_j|^2, sx (..., M, D) and sy
    (..., N, D) -> (..., M, N), as |a|^2 - 2 <a, b> + |b|^2 clamped at 0
    (``_sq_dist_xla``, vargp_tpu/ops/dispatch.py:45-56)."""
    xx = torch.sum(sx * sx, dim=-1)
    yy = torch.sum(sy * sy, dim=-1)
    xy = torch.einsum("...md,...nd->...mn", sx, sy)
    return torch.clamp(xx[..., :, None] - 2.0 * xy + yy[..., None, :], min=0.0)


def rbf_gram(sx: torch.Tensor, sy: torch.Tensor, gamma2: torch.Tensor) -> torch.Tensor:
    """gamma2 exp(-0.5 |sx_i - sy_j|^2) on pre-scaled inputs: sx (..., M, D)
    and sy (..., N, D) with the same batch dims, gamma2 one scalar per
    batch element (...,).  Returns (..., M, N), through K5, differentiable
    in all three."""
    batch, (M, D), N = sx.shape[:-2], sx.shape[-2:], sy.shape[-2]
    if sy.shape[:-2] != batch or tuple(gamma2.shape) != tuple(batch):
        raise ValueError(
            f"rbf_gram: sx {tuple(sx.shape)}, sy {tuple(sy.shape)}, "
            f"gamma2 {tuple(gamma2.shape)}"
        )
    sx3 = sx.reshape(-1, M, D).contiguous()
    # a self-Gram (sy is sx) reaches K5 as one tensor: its symmetric kernel
    sy3 = sx3 if sy is sx else sy.reshape(-1, N, D).contiguous()
    K = _RbfGram.apply(sx3, sy3, gamma2.reshape(-1).contiguous())
    return K.reshape(*batch, M, N)
