"""K5: generic RBF Gram on pre-scaled inputs (``csrc/rbf_gram.cu``).

Replaces ``vargp_tpu/ops/pallas/rbf_gram.py::_gram_3d``, entered through
``rbf_gram_pallas``.  From D = 17 features the tile's two kernels
multiply on the tensor cores in 3xTF32 (``csrc/rbf_mma.cuh``); up to
D = 16 (``SMALL_D``: the toy's two inputs) a third kernel sums the
squared differences in f32, one thread an output, since a 3xTF32 product
is f32-accurate only inside a deep sum.  A CUDA tensor launches one; a CPU
tensor takes :func:`rbf_gram_plain`, the einsum body of
``_rbf_gram_impl`` (``rbf_gram.py:108-112``), or up to SMALL_D the small
kernel's sum of squared differences.
"""

import torch

from vargp_tpu_torch.ops.cuda.build import check_f32_contiguous, launch, on_cpu


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
    """True when sx and sy are the same memory read the same way: equal
    data pointers, shapes and strides (a tensor and itself, or a view of
    it with its shape), as ``ops.dispatch.rbf_gram`` hands over a
    self-Gram."""
    return (sx.data_ptr() == sy.data_ptr() and sx.shape == sy.shape
            and sx.stride() == sy.stride())


def rbf_gram(sx: torch.Tensor, sy: torch.Tensor, gamma2: torch.Tensor) -> torch.Tensor:
    """K[g, i, j] = gamma2[g] exp(-0.5 |sx[g, i] - sy[g, j]|^2).

    On the card, when sx and sy are the same storage (:func:`same_storage`)
    the symmetric kernel computes each distinct entry once and mirrors it:
    the Gram is bitwise symmetric and its diagonal is gamma2 exactly.  Any
    other pair, equal values in two tensors included, takes the cross
    kernel, whose (i, j) and (j, i) agree only to rounding.  Up to SMALL_D
    features the small kernel takes every pair (a self-Gram is bitwise
    symmetric there, gamma2 on its diagonal, and counts as a symmetric
    launch)."""
    if on_cpu(sx, sy, gamma2):
        return rbf_gram_plain(sx, sy, gamma2)
    G, M, D = sx.shape
    N = sy.shape[1]
    if sy.shape != (G, N, D) or gamma2.shape != (G,):
        raise ValueError(
            f"rbf_gram: sx {tuple(sx.shape)}, sy {tuple(sy.shape)}, "
            f"gamma2 {tuple(gamma2.shape)}"
        )
    if G > 65535:
        raise ValueError(f"rbf_gram: G = {G} exceeds the grid's y and z limits")
    check_f32_contiguous("rbf_gram", sx, sy, gamma2)
    out = torch.empty((G, M, N), device=sx.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    if D <= SMALL_D:
        launch("vargp_rbf_gram_small", sx.device, sx.data_ptr(), sy.data_ptr(),
               gamma2.data_ptr(), out.data_ptr(), G, M, N, D)
        rbf_gram.sym_launches += int(same_storage(sx, sy))
    elif same_storage(sx, sy):
        launch("vargp_rbf_gram_sym", sx.device, sx.data_ptr(), gamma2.data_ptr(),
               out.data_ptr(), G, M, D)
        rbf_gram.sym_launches += 1
    else:
        launch("vargp_rbf_gram", sx.device, sx.data_ptr(), sy.data_ptr(), gamma2.data_ptr(),
               out.data_ptr(), G, M, N, D)
    rbf_gram.launches += 1
    return out


rbf_gram.launches = 0  # every launch
rbf_gram.sym_launches = 0  # the symmetric kernel's
