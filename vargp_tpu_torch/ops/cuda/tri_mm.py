"""tri_mm: the product of lower-triangular matrices with a batch of
right-hand sides, ``tril(L) @ X`` (``csrc/tri_mm.cu``).

Replaces no Pallas kernel: the JAX package leaves the predictive
marginal's W = L^-1 K_zx to XLA's dot.  The kernel multiplies on the
tensor cores in 3xTF32 (f32 accuracy) and skips the zero upper triangle:
it reads L on and below the diagonal only.  The operator
``vargp_torch::tri_mm`` launches it for CUDA tensors and takes
:func:`tri_mm_plain`, ``torch.matmul``, for CPU tensors, which equals the
kernel's function wherever L is zero above its diagonal (every L^-1 the
factorisation's routes give).
"""

import math

import torch

from vargp_tpu_torch.ops.cuda.build import (Cost, check_f32_contiguous, kernel_op, launch,
                                            on_card, on_cpu, result_dtype)

_TILE = 128  # the kernel's output tile: rows and columns
_GRID_MAX = 2 ** 31 - 1  # blocks in the kernel's one-dimensional grid


def tri_mm_plain(L: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """L (..., S, S), X (..., S, N) -> L @ X (..., S, N)."""
    return torch.matmul(L, X)


def _check(L, X) -> tuple:
    """Shapes on every device; on the card contiguous float32 and the
    grid's limit.  Returns the output's shape."""
    if L.dim() < 2 or X.dim() != L.dim() or L.shape[-1] != L.shape[-2] \
            or X.shape[-2] != L.shape[-1] or L.shape[:-2] != X.shape[:-2]:
        raise ValueError(
            f"tri_mm: L {tuple(L.shape)} and X {tuple(X.shape)}: expected square L "
            "(..., S, S) and X (..., S, N) with the same leading dimensions"
        )
    if on_card(L):
        check_f32_contiguous("tri_mm", L, X)
        S, N = X.shape[-2:]
        blocks = math.prod(L.shape[:-2]) * -(-S // _TILE) * -(-N // _TILE)
        if blocks > _GRID_MAX:
            raise ValueError(f"tri_mm: {blocks} tiles exceed the grid's limit")
    return X.shape


def cost(L, X) -> Cost:
    """The triangle's S^2 N operations a matrix (S (S + 1) / 2 multiply-adds
    a column, ~S^2 / 2) in 3xTF32; L's lower triangle and X read once, the
    output written once."""
    *lead, S, N = X
    G = math.prod(lead)
    return Cost(G * S * S * N, 4 * G * (S * (S + 1) // 2 + 2 * S * N), "3xtf32")


def _cpu(L, X):
    _check(L, X)
    return tri_mm_plain(L, X)


def _cuda(L, X):
    shape = _check(L, X)
    on_cpu(L, X)  # one device
    out = torch.empty(shape, device=L.device, dtype=torch.float32)
    *lead, S, N = shape
    launch("vargp_tri_mm", L.device, L.data_ptr(), X.data_ptr(), out.data_ptr(),
           math.prod(lead), S, N)
    return out


def _fake(L, X):
    on_cpu(L, X)  # refuses meta tensors and mixed devices
    return X.new_empty(_check(L, X), dtype=result_dtype(L, X))


tri_mm_op = kernel_op("tri_mm", "(Tensor L, Tensor X) -> Tensor", cpu=_cpu, cuda=_cuda,
                      fake=_fake, cost=cost)


def tri_mm(L: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """tril(L) @ X for L (..., S, S) lower triangular and X (..., S, N)
    with the same leading dimensions."""
    return tri_mm_op(L, X)
