"""Packed lower-triangular parameterisation.

Counterpart of ``vargp_tpu/gpmath/tril.py``: the ``m(m+1)/2`` lower
entries are packed row-major (``numpy.tril_indices`` order) and the
diagonal passes through a softplus when unpacking.  ``vec2tril``'s
gradient is autograd's: a gather of the packed entries, which is what the
JAX package's hand rule (``_vec2tril_bwd``) does to avoid a scatter-add.
The JAX package's "filled" layout, a TPU gather workaround, is not ported:
the port packs row-major everywhere.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F


def tril_indices(m: int):
    """The (rows, cols) int32 index arrays of an m x m lower triangle, in
    the packing order."""
    rows, cols = np.tril_indices(m)
    return np.asarray(rows, dtype=np.int32), np.asarray(cols, dtype=np.int32)


def tril_size(m: int) -> int:
    """Number of packed entries of an m x m lower triangle."""
    return (m * (m + 1)) // 2


def tril_dim(d: int) -> int:
    """The m with m(m+1)/2 == d; raises when there is none."""
    m = int((math.sqrt(8.0 * d + 1.0) - 1.0) / 2.0)
    if tril_size(m) != d:
        raise ValueError(f"{d} is not a valid packed-triangle length")
    return m


def vec2tril(vec: torch.Tensor, m: int | None = None) -> torch.Tensor:
    """Unpack ``... x m(m+1)/2`` into ``... x m x m`` lower-triangular
    matrices with a softplus diagonal."""
    if m is None:
        m = tril_dim(vec.shape[-1])
    elif vec.shape[-1] != tril_size(m):
        raise ValueError(
            f"vec2tril: packed length {vec.shape[-1]} does not match m={m} "
            f"(expected {tril_size(m)})"
        )
    rows, cols = torch.tril_indices(m, m, device=vec.device)
    out = vec.new_zeros((*vec.shape[:-1], m, m))
    out[..., rows, cols] = vec
    eye = torch.eye(m, dtype=torch.bool, device=vec.device)
    return torch.where(eye, F.softplus(out), out)


def mat2trilvec(mat: torch.Tensor) -> torch.Tensor:
    """Pack ``... x m x m`` into the ``... x m(m+1)/2`` lower triangle (no
    transform: the inverse of vec2tril's layout only)."""
    m = mat.shape[-1]
    rows, cols = torch.tril_indices(m, m, device=mat.device)
    return mat[..., rows, cols]
