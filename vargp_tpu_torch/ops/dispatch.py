"""Kernel dispatch and the forward of the Gram factorisation.

Counterpart of ``vargp_tpu/ops/dispatch.py``, forward only.  Dispatch is
by the tensors' device: the kernel wrappers in ``ops.cuda`` launch their
kernels for CUDA tensors and run their plain versions for CPU tensors.
"""

import torch

# Blocked-split rule of vargp_tpu/ops/dispatch.py:185-214.  The upper bound
# is the diagonal-block kernel's: K3 takes blocks of at most 128 rows, as
# the Pallas backend has it.
_BLOCK_LO, _BLOCK_HI = 96, 128
_FACTOR_BLOCKED_ABOVE = 160  # the JAX package's _BLOCK_HI on other backends
_MAX_BLOCKS = 8
_PAD_WASTE_LIMIT = 0.15


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


def chol_and_inv(K: torch.Tensor):
    """(chol(K), chol(K)^{-1}) of a batch of SPD matrices (forward of
    ``_chol_and_inv_impl``)."""
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
