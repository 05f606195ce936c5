"""The auto-regressive joint posterior over the inducing chain, and the
diagonal predictive marginal read from it.

Counterpart of the fused path of ``vargp_tpu/gpmath/conditional.py``, in
its three forms:

- whitened-factored (``ar_joint_posterior_factored``,
  ``whitened_marginal_diag_factored``; the default): with L the Cholesky
  factor of the whole chain's inducing Gram, the joint posterior's scale
  factor is L blockdiag(w) and its mean L v, where w_t = inv(L_tt)
  u_tril_t and v_t = inv(L_tt) u_mean_t; inv(L_tt) are the diagonal
  blocks of L^{-1}.  Neither L blockdiag(w) nor L v is formed;
- materialised (``ar_joint_posterior``: the task-by-task fold, through
  L^{-1} or by triangular solves; ``ar_joint_posterior_fast``: the
  closed-form block-LDL build), read by ``whitened_marginal_diag``.

and the reference-parity primitives of that module (``gp_cond``,
``linear_joint``, ``linear_marginal_diag`` and its ``MarginalCache``),
which factor through ``gpmath.cholesky`` (K7 on the card) and
``tri_solve``.  No model path of either package calls them: they are the
JAX package's test oracles for the fused path.
"""

from typing import NamedTuple, Sequence

import torch

from vargp_tpu_torch.gpmath.linalg import cholesky, mm_h, mtm_h, tri_half_split, tri_solve
from vargp_tpu_torch.ops.cuda.marginal_moments import (MAX_M, marginal_moments,
                                                       marginal_moments_plain)
from vargp_tpu_torch.ops.cuda.tri_mm import tri_mm


# ---------------------------------------------------------------------------
# Reference-parity primitives
# ---------------------------------------------------------------------------


def gp_cond(u, Kzz, Kzx, Kxx, Lz=None, Lz_Kzx=None):
    """GP conditional p(f | u): mu = Kxz Kzz^{-1} u and
    Sigma = Kxx - Kxz Kzz^{-1} Kzx, through the whitened factor
    Lz^{-1} Kzx.  u (..., M, 1), Kzz (..., M, M), Kzx (..., M, N),
    Kxx (..., N, N); Lz and Lz^{-1} Kzx may be passed in.  Returns
    mu (..., N, 1) and Sigma (..., N, N)."""
    if Lz is None:
        Lz = cholesky(Kzz)
    Lz_u = tri_solve(Lz, u)
    if Lz_Kzx is None:
        Lz_Kzx = tri_solve(Lz, Kzx)
    mu = torch.einsum("...ij,...ik->...jk", Lz_Kzx, Lz_u)
    Sigma = Kxx - torch.einsum("...ij,...ik->...jk", Lz_Kzx, Lz_Kzx)
    return mu, Sigma


def linear_joint(m, S, Kzx, Kzz, V, b):
    """Joint of N(z; m, S) and N(x; A z + b, V), A = Kxz Kzz^{-1}:
    mu = [m, A m + b], Sigma = [[S, S A^T], [A S, V + A S A^T]]."""
    Lz = cholesky(Kzz)
    Lz_m = tri_solve(Lz, m)
    Lz_Kzx = tri_solve(Lz, Kzx)
    Am = torch.einsum("...ij,...ik->...jk", Lz_Kzx, Lz_m)
    Lz_S = tri_solve(Lz, torch.broadcast_to(S, torch.broadcast_shapes(S.shape, Lz.shape)))
    AS = torch.einsum("...ij,...ik->...jk", Lz_Kzx, Lz_S)
    SAt = AS.transpose(-2, -1)
    Lz_SAt = tri_solve(Lz, SAt)
    ASAt = torch.einsum("...ij,...ik->...jk", Lz_SAt, Lz_Kzx)
    mu = torch.cat([torch.broadcast_to(m, Am.shape[:-2] + m.shape[-2:]), Am + b], dim=-2)
    top = torch.cat([torch.broadcast_to(S, AS.shape[:-2] + S.shape[-2:]), SAt], dim=-1)
    bot = torch.cat([AS, V + ASAt], dim=-1)
    return mu, torch.cat([top, bot], dim=-2)


class MarginalCache(NamedTuple):
    Lz: torch.Tensor
    Lz_Kzx: torch.Tensor


def linear_marginal_diag(m, S, Kzz, Kzx, Kxx_diag, *, return_cache: bool = False):
    """Diagonal marginal of the same linear-Gaussian product:
    mu = A m, var = Kxx_diag - diag(A Kzx) + diag(A S A^T), S factored
    here.  m (..., M, 1); returns mu and var (..., N), and with
    ``return_cache`` the ``MarginalCache`` (Lz, Lz^{-1} Kzx)."""
    Lz = cholesky(Kzz)
    Lz_m = tri_solve(Lz, m)
    Lz_Kzx = tri_solve(Lz, Kzx)
    mu = torch.einsum("...ij,...ik->...jk", Lz_Kzx, Lz_m)[..., 0]
    diag1 = torch.sum(torch.square(Lz_Kzx), dim=-2)
    Lz_LS = tri_solve(Lz, cholesky(S))
    C = torch.einsum("...ij,...ik->...jk", Lz_LS, Lz_Kzx)
    var = Kxx_diag - diag1 + torch.sum(torch.square(C), dim=-2)
    if return_cache:
        return mu, var, MarginalCache(Lz=Lz, Lz_Kzx=Lz_Kzx)
    return mu, var


# ---------------------------------------------------------------------------
# The fused path
# ---------------------------------------------------------------------------


class ARPosterior(NamedTuple):
    """q(u_{<=t} | theta) = N(mean, LS LS^T): mean (..., S, 1), LS
    (..., S, S) block-lower-triangular.  Leading blocks are the prefix
    posteriors."""

    mean: torch.Tensor
    LS: torch.Tensor


class ARFactored(NamedTuple):
    v: torch.Tensor  # (..., S, 1) whitened mean L^{-1} mean
    w: torch.Tensor  # (..., T, M, M) whitened per-task scale factors


def _diag_blocks(A: torch.Tensor, T: int, M: int) -> torch.Tensor:
    """(..., T*M, T*M) -> its diagonal M-blocks (..., T, M, M), as a view.

    Its gradient is autograd's ``diagonal`` backward: one (T*M)^2 buffer
    with the blocks written in, which is what the JAX package's hand rule
    (``_diag_blocks_bwd``) builds; a stack of T slices would sum T full
    buffers instead."""
    blocks = A.unflatten(-1, (T, M)).unflatten(-3, (T, M))  # (..., T, M, T, M)
    return torch.diagonal(blocks, dim1=-4, dim2=-2).movedim(-1, -3)


def ar_joint_posterior_factored(
    L_full: torch.Tensor,
    L_inv: torch.Tensor,
    u_means: Sequence[torch.Tensor],
    u_trils: Sequence[torch.Tensor],
) -> ARFactored:
    """Whitened-factored AR joint posterior for a chain of equal task
    blocks.  ``u_means[t]`` (..., M, 1) and ``u_trils[t]`` (..., M, M)
    are task t's variational mean and scale factor."""
    sizes = [u.shape[-2] for u in u_means]
    M, T = sizes[0], len(sizes)
    if any(m != M for m in sizes):
        raise NotImplementedError(f"unequal task blocks {sizes}")
    batch = torch.broadcast_shapes(L_full.shape[:-2], *[u.shape[:-2] for u in u_means])
    um_b = torch.broadcast_shapes(*[u.shape[:-2] for u in u_means])
    ut_b = torch.broadcast_shapes(*[u.shape[:-2] for u in u_trils])
    um = torch.stack([torch.broadcast_to(u, (*um_b, M, 1)) for u in u_means], dim=-3)
    ut = torch.stack([torch.broadcast_to(u, (*ut_b, M, M)) for u in u_trils], dim=-3)
    Dinv = _diag_blocks(L_inv, T, M)
    w = mm_h(Dinv, ut)  # (..., T, M, M)
    v = mm_h(Dinv, um)  # (..., T, M, 1)
    v_full = torch.broadcast_to(v, (*batch, T, M, 1)).reshape(*batch, T * M, 1)
    return ARFactored(v=v_full, w=torch.broadcast_to(w, (*batch, T, M, M)))


def takes_tri_mm(L_inv: torch.Tensor, Kzx: torch.Tensor) -> bool:
    """Whether W = L^{-1} Kzx takes ``tri_mm``: both operands on the card,
    neither recording a gradient (the kernel has no backward rule, so the
    ELBO step keeps the dense product) and the same leading dimensions (no
    broadcast).  On the CPU the dense product is the kernel's plain version
    anyway."""
    return (L_inv.is_cuda and Kzx.is_cuda and not (L_inv.requires_grad or Kzx.requires_grad)
            and L_inv.shape[:-2] == Kzx.shape[:-2])


def takes_marginal_moments(W: torch.Tensor, v_mean: torch.Tensor, w: torch.Tensor,
                           Kxx_diag: torch.Tensor) -> bool:
    """Whether W's readers take ``marginal_moments``: every operand on the
    card, none recording a gradient (the kernel has no backward rule, so the
    ELBO step keeps the dense chain), no operand broadcast against W's
    leading dimensions, and task blocks the kernel's shared memory holds
    (at most ``MAX_M`` rows).  The operator checks the rest of its shapes.
    On the CPU the chain is the kernel's plain version anyway."""
    ops = (W, v_mean, w, Kxx_diag)
    return (all(t.is_cuda and not t.requires_grad for t in ops)
            and W.shape[:-2] == v_mean.shape[:-2] == w.shape[:-3]
            and Kxx_diag.shape[:-2] == W.shape[:-3] and w.shape[-1] <= MAX_M)


def whitened_marginal_diag_factored(
    L_inv: torch.Tensor,
    v_mean: torch.Tensor,
    w: torch.Tensor,
    Kzx: torch.Tensor,
    Kxx_diag: torch.Tensor,
):
    """Diagonal predictive marginal (f_mean, f_var), each (..., B):

      f_mean = v^T W,  f_var = Kxx - diag(W^T W) + diag(C^T C),
      W = L^{-1} Kzx,  C_t = w_t^T W_t.

    W goes through the triangular product ``tri_mm`` (3xTF32, L^{-1}'s zero
    upper triangle skipped) when :func:`takes_tri_mm` holds, else through
    the dense ``mm_h``; its readers through ``marginal_moments`` (one pass
    over W, w_t's zero upper triangle skipped) when
    :func:`takes_marginal_moments` holds, else through the dense chain
    ``marginal_moments_plain``: the same values to f32 accuracy."""
    if takes_tri_mm(L_inv, Kzx):
        W = tri_mm(L_inv.contiguous(), Kzx.contiguous())  # (..., S, B)
    else:
        W = mm_h(L_inv, Kzx)
    if takes_marginal_moments(W, v_mean, w, Kxx_diag):
        return marginal_moments(W.contiguous(), v_mean.contiguous(), w.contiguous(),
                                Kxx_diag.contiguous())
    return marginal_moments_plain(W, v_mean, w, Kxx_diag)


def ar_joint_posterior(
    L_full: torch.Tensor,
    u_means: Sequence[torch.Tensor],
    u_trils: Sequence[torch.Tensor],
    L_inv: torch.Tensor | None = None,
) -> ARPosterior:
    """Fold the chain task by task into (mean, LS) using sub-blocks of the
    whole chain's factor: with c rows folded, task t's block is
    [A mean + u_mean_t] and [A LS, u_tril_t], A X = L21 L11^{-1} X,
    L11^{-1} taken from ``L_inv``'s leading block or by a triangular
    solve.  Task blocks may differ in size."""
    sizes = [u.shape[-2] for u in u_means]
    batch = torch.broadcast_shapes(L_full.shape[:-2], *[u.shape[:-2] for u in u_means])
    c = sizes[0]
    mean = torch.broadcast_to(u_means[0], (*batch, c, 1))
    LS = torch.broadcast_to(u_trils[0], (*batch, c, c))
    for t in range(1, len(sizes)):
        Mt = sizes[t]
        rhs = torch.cat([mean, LS], dim=-1)
        if L_inv is not None:
            w = mm_h(L_inv[..., :c, :c], rhs)
        else:
            w = tri_solve(L_full[..., :c, :c], rhs)
        AX = mm_h(L_full[..., c:c + Mt, :c], w)
        mean = torch.cat([mean, AX[..., :1] + u_means[t]], dim=-2)
        top = torch.cat([LS, LS.new_zeros((*batch, c, Mt))], dim=-1)
        bot = torch.cat([AX[..., 1:], torch.broadcast_to(u_trils[t], (*batch, Mt, Mt))], dim=-1)
        LS = torch.cat([top, bot], dim=-2)
        c += Mt
    return ARPosterior(mean=mean, LS=LS)


def ar_joint_posterior_fast(
    L_full: torch.Tensor,
    L_inv: torch.Tensor,
    u_means: Sequence[torch.Tensor],
    u_trils: Sequence[torch.Tensor],
) -> ARPosterior:
    """Closed-form AR joint posterior: mean = L blockdiag(inv(L_tt)) b and
    LS = L blockdiag(inv(L_tt) u_tril_t), two batched products instead of
    the fold.  One task is its own posterior; unequal blocks take the
    fold."""
    sizes = [u.shape[-2] for u in u_means]
    batch = torch.broadcast_shapes(L_full.shape[:-2], *[u.shape[:-2] for u in u_means])
    T, M = len(sizes), sizes[0]
    S = sum(sizes)
    if T == 1:
        return ARPosterior(mean=torch.broadcast_to(u_means[0], (*batch, M, 1)),
                           LS=torch.broadcast_to(u_trils[0], (*batch, M, M)))
    if any(m != M for m in sizes):
        return ar_joint_posterior(L_full, u_means, u_trils, L_inv=L_inv)
    um = torch.stack([torch.broadcast_to(u, (*batch, M, 1)) for u in u_means])
    ut = torch.stack([torch.broadcast_to(u, (*batch, M, M)) for u in u_trils])
    Lb_full = torch.broadcast_to(L_full, (*batch, S, S))
    Dinv = torch.movedim(_diag_blocks(torch.broadcast_to(L_inv, (*batch, S, S)), T, M), -3, 0)
    w = mm_h(Dinv, ut)  # (T, *batch, M, M)
    v = mm_h(Dinv, um)  # (T, *batch, M, 1)
    Lb = torch.movedim(Lb_full.reshape(*batch, S, T, M), -2, 0)  # (T, *batch, S, M)
    LS = torch.movedim(mm_h(Lb, w), 0, -2).reshape(*batch, S, S)
    mean = torch.einsum("t...sm,t...mk->...sk", Lb, v)
    return ARPosterior(mean=mean, LS=LS)


def whitened_marginal_diag(
    L: torch.Tensor,
    mean: torch.Tensor,
    LS: torch.Tensor,
    Kzx: torch.Tensor,
    Kxx_diag: torch.Tensor,
    L_inv: torch.Tensor | None = None,
):
    """Diagonal predictive marginal (f_mean, f_var), each (..., B), from the
    materialised posterior:

      f_mean = Kxz K^{-1} mean,
      f_var  = Kxx - diag(Kxz K^{-1} Kzx) + diag(Kxz K^{-1} S K^{-1} Kzx),

    the three whitened factors as products with ``L_inv`` or, without it,
    one triangular solve.  From M = 512 rows the L_inv branch skips the
    zero upper block of L^{-1} LS on a 2 x 2 split (plain slices)."""
    M = L.shape[-1]
    batch = torch.broadcast_shapes(L.shape[:-2], LS.shape[:-2], mean.shape[:-2], Kzx.shape[:-2])
    diag2 = None
    if L_inv is not None:
        Lm = mm_h(L_inv, mean)
        W = mm_h(L_inv, Kzx)
        h = tri_half_split(M)
        if h is not None:
            a1, a2, a3 = L_inv[..., :h, :h], L_inv[..., h:, :h], L_inv[..., h:, h:]
            s1, s2, s3 = LS[..., :h, :h], LS[..., h:, :h], LS[..., h:, h:]
            M11 = mm_h(a1, s1)
            M21 = mm_h(a2, s1) + mm_h(a3, s2)
            M22 = mm_h(a3, s3)
            W1, W2 = W[..., :h, :], W[..., h:, :]
            Ctop = mtm_h(M11, W1) + mtm_h(M21, W2)
            Cbot = mtm_h(M22, W2)
            diag2 = torch.sum(torch.square(Ctop), dim=-2) + torch.sum(torch.square(Cbot), dim=-2)
        else:
            LLS = mm_h(L_inv, LS)
    else:
        rhs = torch.cat([
            torch.broadcast_to(mean, (*batch, *mean.shape[-2:])),
            torch.broadcast_to(LS, (*batch, *LS.shape[-2:])),
            torch.broadcast_to(Kzx, (*batch, *Kzx.shape[-2:])),
        ], dim=-1)
        sol = tri_solve(L, rhs)
        Lm, LLS, W = sol[..., :1], sol[..., 1:1 + M], sol[..., 1 + M:]
    f_mean = torch.einsum("...mi,...mb->...b", Lm, W)
    diag1 = torch.sum(torch.square(W), dim=-2)
    if diag2 is None:
        diag2 = torch.sum(torch.square(mtm_h(LLS, W)), dim=-2)
    # exact value >= diag2 >= 0; the clamp only removes rounding below 0
    f_var = torch.clamp(Kxx_diag - diag1 + diag2, min=0.0)
    return f_mean, f_var
