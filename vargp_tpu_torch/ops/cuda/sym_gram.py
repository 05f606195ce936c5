"""K1: symmetric fused-scaling ARD-RBF Gram (``csrc/sym_gram.cu``).

Replaces ``vargp_tpu/ops/pallas/rbf_gram.py::_sym_gram_4d``.  K2's design
on 64 x 64 tiles: the lower tile pairs on the tensor cores in 3xTF32
(``csrc/rbf_mma.cuh``), each distinct entry computed once and mirrored, so
the output is bitwise symmetric, gamma2 exactly on the diagonal, and equal
to K2's bit for bit.  A CUDA tensor launches the kernel; a CPU tensor takes
:func:`sym_gram_plain`, the einsum formulation of ``_sym_gram_xla_math``
(``rbf_gram.py:524``).
"""

import torch

from vargp_tpu_torch.ops.cuda.build import check_f32_contiguous, launch, on_cpu


def sym_gram_plain(z: torch.Tensor, invs: torch.Tensor,
                   gamma2: torch.Tensor) -> torch.Tensor:
    """z (O, M, D), invs (H, D), gamma2 (H,) -> (H, O, M, M)."""
    sz = z[None] * invs[:, None, None, :]  # (H, O, M, D)
    nn = torch.sum(sz * sz, dim=-1)
    xy = torch.einsum("homd,hond->homn", sz, sz)
    d2 = torch.clamp(nn[..., :, None] - 2.0 * xy + nn[..., None, :], min=0.0)
    return gamma2[:, None, None, None] * torch.exp(-0.5 * d2)


def sym_gram(z: torch.Tensor, invs: torch.Tensor,
             gamma2: torch.Tensor) -> torch.Tensor:
    """K[h, o, i, j] = gamma2[h] exp(-0.5 sum_d invs[h, d]^2 (z[o,i,d] - z[o,j,d])^2)."""
    if on_cpu(z, invs, gamma2):
        return sym_gram_plain(z, invs, gamma2)
    O, M, D = z.shape
    H = invs.shape[0]
    if invs.shape != (H, D) or gamma2.shape != (H,):
        raise ValueError(
            f"sym_gram: z {tuple(z.shape)}, invs {tuple(invs.shape)}, "
            f"gamma2 {tuple(gamma2.shape)}"
        )
    if H * O > 65535:
        raise ValueError(f"sym_gram: H*O = {H * O} exceeds the grid's y limit")
    check_f32_contiguous("sym_gram", z, invs, gamma2)
    out = torch.empty((H, O, M, M), device=z.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    launch(
        "vargp_sym_gram", z.device, z.data_ptr(), invs.data_ptr(), gamma2.data_ptr(),
        out.data_ptr(), H, O, M, D,
    )
    sym_gram.launches += 1
    return out


sym_gram.launches = 0
