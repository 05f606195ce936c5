"""K5: generic RBF Gram on pre-scaled inputs (``csrc/rbf_gram.cu``).

Replaces ``vargp_tpu/ops/pallas/rbf_gram.py::_gram_3d``, entered through
``rbf_gram_pallas``.  From D = 17 features the tile's two kernels
multiply on the tensor cores in 3xTF32 (``csrc/rbf_mma.cuh``); up to
D = 16 (``SMALL_D``: the toy's two inputs) a third kernel sums the
squared differences in f32, one thread an output, since a 3xTF32 product
is f32-accurate only inside a deep sum.  Two operators,
``vargp_torch::rbf_gram`` (two inputs) and ``vargp_torch::rbf_gram_sym``
(a self-Gram), launch one for CUDA tensors; for CPU tensors they take
:func:`rbf_gram_plain`, the einsum body of ``_rbf_gram_impl``
(``rbf_gram.py:108-112``), or up to SMALL_D the small kernel's sum of
squared differences.
"""

import torch

from vargp_tpu_torch.ops.cuda.build import (Cost, check_f32_contiguous, kernel_op, launch,
                                            on_card, on_cpu, result_dtype)


SMALL_D = 16  # the most features the small kernel takes


def rbf_gram_plain(sx: torch.Tensor, sy: torch.Tensor,
                   gamma2: torch.Tensor) -> torch.Tensor:
    """sx (G, M, D), sy (G, N, D), gamma2 (G,) -> (G, M, N): d^2 as
    |a|^2 + |b|^2 - 2 <a, b>, or up to SMALL_D features, as the small
    kernel takes it, the squared differences summed feature by feature."""
    if sx.shape[-1] <= SMALL_D:
        d2 = sx.new_zeros((*sx.shape[:-1], sy.shape[-2]))
        for k in range(sx.shape[-1]):
            d = sx[..., :, None, k] - sy[..., None, :, k]
            d2 = d2 + d * d
        return gamma2[:, None, None] * torch.exp(-0.5 * d2)
    xx = torch.sum(sx * sx, dim=-1)
    yy = torch.sum(sy * sy, dim=-1)
    xy = torch.einsum("gmd,gnd->gmn", sx, sy)
    d2 = torch.clamp(xx[..., :, None] - 2.0 * xy + yy[..., None, :], min=0.0)
    return gamma2[:, None, None] * torch.exp(-0.5 * d2)


def same_storage(sx: torch.Tensor, sy: torch.Tensor) -> bool:
    """True when sx and sy are the same memory read the same way: one
    tensor, or one storage at equal offsets, shapes and strides
    (``Tensor.is_set_to``: a view of a tensor with its shape), as
    ``ops.dispatch.rbf_gram`` hands over a self-Gram.  While ``torch.export``
    traces, tensors are fake and hold no storage: one is the same storage
    only as itself."""
    if sx is sy:
        return True
    if torch.compiler.is_compiling() or sx.shape != sy.shape or sx.stride() != sy.stride():
        return False
    return sx.is_set_to(sy)


def _check(sx, sy, gamma2) -> tuple:
    """Shapes on every device; on the card the grid's limit and contiguous
    float32.  Returns the output's shape."""
    G, M, D = sx.shape
    N = sy.shape[1]
    if sy.shape != (G, N, D) or gamma2.shape != (G,):
        raise ValueError(
            f"rbf_gram: sx {tuple(sx.shape)}, sy {tuple(sy.shape)}, "
            f"gamma2 {tuple(gamma2.shape)}"
        )
    if on_card(sx):
        if G > 65535:
            raise ValueError(f"rbf_gram: G = {G} exceeds the grid's y and z limits")
        check_f32_contiguous("rbf_gram", sx, sy, gamma2)
    return (G, M, N)


def precision(D: int) -> str:
    """The precision class of the kernel that runs at D features: the
    small kernel's f32 up to SMALL_D, the tile's 3xTF32 above."""
    return "f32" if D <= SMALL_D else "3xtf32"


def cost(sx, sy, gamma2) -> Cost:
    """The cross mode: every (i, j) pair's D-long product (2 G M N D; the
    small kernel's D differences are billed the same), the inputs read
    once and the output written once."""
    (G, M, D), (_, N, _) = sx, sy
    return Cost(2 * G * M * N * D, 4 * (G * M * D + G * N * D + G + G * M * N), precision(D))


def sym_cost(sx, gamma2) -> Cost:
    """The symmetric mode: each mirrored pair once (G M^2 D, half the cross
    mode's; the small kernel, which takes every pair, is billed the same),
    sx read once, the Gram written once."""
    G, M, D = sx
    return Cost(G * M * M * D, 4 * (G * M * D + G + G * M * M), precision(D))


def _cpu(sx, sy, gamma2):
    _check(sx, sy, gamma2)
    return rbf_gram_plain(sx, sy, gamma2)


def _cuda(sx, sy, gamma2):
    G, M, N = _check(sx, sy, gamma2)
    on_cpu(sx, sy, gamma2)  # one device
    out = torch.empty((G, M, N), device=sx.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    small = sx.shape[-1] <= SMALL_D
    launch("vargp_rbf_gram_small" if small else "vargp_rbf_gram", sx.device, sx.data_ptr(),
           sy.data_ptr(), gamma2.data_ptr(), out.data_ptr(), G, M, N, sx.shape[-1])
    return out


def _fake(sx, sy, gamma2):
    on_cpu(sx, sy, gamma2)  # refuses meta tensors and mixed devices
    return sx.new_empty(_check(sx, sy, gamma2), dtype=result_dtype(sx, sy, gamma2))


def _cpu_sym(sx, gamma2):
    _check(sx, sx, gamma2)
    return rbf_gram_plain(sx, sx, gamma2)


def _cuda_sym(sx, gamma2):
    G, M, _ = _check(sx, sx, gamma2)
    on_cpu(sx, gamma2)  # one device
    out = torch.empty((G, M, M), device=sx.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    D = sx.shape[-1]
    if D <= SMALL_D:  # the small kernel takes every pair
        launch("vargp_rbf_gram_small", sx.device, sx.data_ptr(), sx.data_ptr(),
               gamma2.data_ptr(), out.data_ptr(), G, M, M, D)
    else:
        launch("vargp_rbf_gram_sym", sx.device, sx.data_ptr(), gamma2.data_ptr(),
               out.data_ptr(), G, M, D)
    return out


def _fake_sym(sx, gamma2):
    on_cpu(sx, gamma2)  # refuses meta tensors and mixed devices
    return sx.new_empty(_check(sx, sx, gamma2), dtype=result_dtype(sx, gamma2))


rbf_gram_op = kernel_op("rbf_gram", "(Tensor sx, Tensor sy, Tensor gamma2) -> Tensor",
                        cpu=_cpu, cuda=_cuda, fake=_fake, cost=cost)
rbf_gram_sym_op = kernel_op("rbf_gram_sym", "(Tensor sx, Tensor gamma2) -> Tensor",
                            cpu=_cpu_sym, cuda=_cuda_sym, fake=_fake_sym, cost=sym_cost)


def rbf_gram(sx: torch.Tensor, sy: torch.Tensor, gamma2: torch.Tensor) -> torch.Tensor:
    """K[g, i, j] = gamma2[g] exp(-0.5 |sx[g, i] - sy[g, j]|^2).

    When sx and sy are the same storage (:func:`same_storage`) the operator
    ``vargp_torch::rbf_gram_sym`` takes the one tensor: on the card its
    kernel computes each distinct entry once and mirrors it, so the Gram is
    bitwise symmetric and its diagonal is gamma2 exactly.  Any other pair,
    equal values in two tensors included, takes ``vargp_torch::rbf_gram``,
    the cross kernel, whose (i, j) and (j, i) agree only to rounding.  Up
    to SMALL_D features the small kernel serves both (a self-Gram is
    bitwise symmetric there, gamma2 on its diagonal, and counts as a
    symmetric launch)."""
    if same_storage(sx, sy):
        return rbf_gram_sym_op(sx, gamma2)
    return rbf_gram_op(sx, sy, gamma2)

