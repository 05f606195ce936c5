"""The auto-regressive joint posterior in whitened-factored form, and the
diagonal predictive marginal read from it.

Counterpart of ``ar_joint_posterior_factored`` and
``whitened_marginal_diag_factored`` in ``vargp_tpu/gpmath/conditional.py``.
With L the Cholesky factor of the whole chain's inducing Gram, the joint
posterior's scale factor is L blockdiag(w) and its mean L v, where
w_t = inv(L_tt) u_tril_t and v_t = inv(L_tt) u_mean_t; inv(L_tt) are the
diagonal blocks of L^{-1}.  Neither L blockdiag(w) nor L v is formed.
"""

from typing import NamedTuple, Sequence

import torch

from vargp_tpu_torch.gpmath.linalg import mm_h, mtm_h


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


def whitened_marginal_diag_factored(
    L_inv: torch.Tensor,
    v_mean: torch.Tensor,
    w: torch.Tensor,
    Kzx: torch.Tensor,
    Kxx_diag: torch.Tensor,
):
    """Diagonal predictive marginal (f_mean, f_var), each (..., B):

      f_mean = v^T W,  f_var = Kxx - diag(W^T W) + diag(C^T C),
      W = L^{-1} Kzx,  C_t = w_t^T W_t."""
    T, M = w.shape[-3], w.shape[-1]
    W = mm_h(L_inv, Kzx)  # (..., S, B)
    f_mean = torch.einsum("...mi,...mb->...b", v_mean, W)
    diag1 = torch.sum(torch.square(W), dim=-2)
    W4 = W.reshape(*W.shape[:-2], T, M, W.shape[-1])
    C = mtm_h(w, W4)  # (..., T, M, B)
    diag2 = torch.sum(torch.square(C), dim=(-3, -2))
    # exact value >= diag2 >= 0; the clamp only removes rounding below 0
    f_var = torch.clamp(Kxx_diag - diag1 + diag2, min=0.0)
    return f_mean, f_var
