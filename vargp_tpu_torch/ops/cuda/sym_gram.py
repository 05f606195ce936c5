"""K1: symmetric fused-scaling ARD-RBF Gram (``csrc/sym_gram.cu``).

Replaces ``vargp_tpu/ops/pallas/rbf_gram.py::_sym_gram_4d``.  K2's design
on 64 x 64 tiles: the lower tile pairs on the tensor cores in 3xTF32
(``csrc/rbf_mma.cuh``), each distinct entry computed once and mirrored, so
the output is bitwise symmetric, gamma2 exactly on the diagonal, and equal
to K2's bit for bit.  The operator ``vargp_torch::sym_gram`` launches the
kernel for CUDA tensors and takes :func:`sym_gram_plain`, the einsum
formulation of ``_sym_gram_xla_math`` (``rbf_gram.py:524``), for CPU
tensors.
"""

import torch

from vargp_tpu_torch.ops.cuda.build import (Cost, check_f32_contiguous, kernel_op, launch,
                                            on_card, on_cpu, result_dtype)

SCHEMA = "(Tensor z, Tensor invs, Tensor gamma2) -> Tensor"


def sym_gram_plain(z: torch.Tensor, invs: torch.Tensor,
                   gamma2: torch.Tensor) -> torch.Tensor:
    """z (O, M, D), invs (H, D), gamma2 (H,) -> (H, O, M, M)."""
    sz = z[None] * invs[:, None, None, :]  # (H, O, M, D)
    nn = torch.sum(sz * sz, dim=-1)
    xy = torch.einsum("homd,hond->homn", sz, sz)
    d2 = torch.clamp(nn[..., :, None] - 2.0 * xy + nn[..., None, :], min=0.0)
    return gamma2[:, None, None, None] * torch.exp(-0.5 * d2)


def check_sym(name: str, z, invs, gamma2) -> tuple:
    """K1's and K2's checks: shapes on every device; on the card the grid's
    limit and contiguous float32.  Returns the output's shape."""
    O, M, D = z.shape
    H = invs.shape[0]
    if invs.shape != (H, D) or gamma2.shape != (H,):
        raise ValueError(
            f"{name}: z {tuple(z.shape)}, invs {tuple(invs.shape)}, "
            f"gamma2 {tuple(gamma2.shape)}"
        )
    if on_card(z):
        if H * O > 65535:
            raise ValueError(f"{name}: H*O = {H * O} exceeds the grid's y limit")
        check_f32_contiguous(name, z, invs, gamma2)
    return (H, O, M, M)


def sym_cost(z, invs, gamma2) -> Cost:
    """One symmetric Gram: each distinct (i, j) pair's D-long product once
    (H O M^2 D multiply-adds' worth, the JAX K2's estimate) in 3xTF32, z,
    invs and gamma2 read once, the output written once."""
    (O, M, D), (H, _) = z, invs
    return Cost(H * O * M * M * D, 4 * (O * M * D + H * D + H + H * O * M * M), "3xtf32")


def _cpu(z, invs, gamma2):
    check_sym("sym_gram", z, invs, gamma2)
    return sym_gram_plain(z, invs, gamma2)


def _cuda(z, invs, gamma2):
    H, O, M, _ = check_sym("sym_gram", z, invs, gamma2)
    on_cpu(z, invs, gamma2)  # one device
    out = torch.empty((H, O, M, M), device=z.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    launch(
        "vargp_sym_gram", z.device, z.data_ptr(), invs.data_ptr(), gamma2.data_ptr(),
        out.data_ptr(), H, O, M, z.shape[-1],
    )
    return out


def _fake(z, invs, gamma2):
    on_cpu(z, invs, gamma2)  # refuses meta tensors and mixed devices
    return z.new_empty(check_sym("sym_gram", z, invs, gamma2), dtype=result_dtype(z, invs, gamma2))


sym_gram_op = kernel_op("sym_gram", SCHEMA, cpu=_cpu, cuda=_cuda, fake=_fake, cost=sym_cost)


def sym_gram(z: torch.Tensor, invs: torch.Tensor,
             gamma2: torch.Tensor) -> torch.Tensor:
    """K[h, o, i, j] = gamma2[h] exp(-0.5 sum_d invs[h, d]^2 (z[o,i,d] - z[o,j,d])^2)."""
    return sym_gram_op(z, invs, gamma2)

