"""K4: fused-scaling ARD-RBF cross Gram (``csrc/cross_gram.cu``).

Replaces ``vargp_tpu/ops/pallas/rbf_gram.py::_cross_gram_4d``.  The kernel
multiplies on the tensor cores in 3xTF32 (``csrc/rbf_mma.cuh``), f32
accuracy.  The operator ``vargp_torch::cross_gram`` launches the kernel for
CUDA tensors and takes :func:`cross_gram_plain`, the einsum body of
``_cross_gram_impl`` (``rbf_gram.py:477-482``), for CPU tensors.
"""

import torch

from vargp_tpu_torch.ops.cuda.build import (Cost, check_f32_contiguous, kernel_op, launch,
                                            on_card, on_cpu, result_dtype)


def cross_gram_plain(z: torch.Tensor, x: torch.Tensor, invs2: torch.Tensor,
                     gamma2: torch.Tensor) -> torch.Tensor:
    """z (O, M, D), x (B, D), invs2 (H, D), gamma2 (H,) -> (H, O, M, B)."""
    xs = x[None] * invs2[:, None, :]  # (H, B, D)
    cross = torch.einsum("oid,hbd->hoib", z, xs)
    zz = torch.einsum("oid,hd->hoi", z * z, invs2)
    xx = torch.einsum("bd,hd->hb", x * x, invs2)
    d2 = torch.clamp(zz[..., None] + xx[:, None, None, :] - 2.0 * cross, min=0.0)
    return gamma2[:, None, None, None] * torch.exp(-0.5 * d2)


def _check(z, x, invs2, gamma2) -> tuple:
    """Shapes on every device; on the card the grid's limit and contiguous
    float32.  Returns the output's shape."""
    O, M, D = z.shape
    B = x.shape[0]
    H = invs2.shape[0]
    if x.shape != (B, D) or invs2.shape != (H, D) or gamma2.shape != (H,):
        raise ValueError(
            f"cross_gram: z {tuple(z.shape)}, x {tuple(x.shape)}, invs2 "
            f"{tuple(invs2.shape)}, gamma2 {tuple(gamma2.shape)}"
        )
    if on_card(z):
        if H * O > 65535:
            raise ValueError(f"cross_gram: H*O = {H * O} exceeds the grid's z limit")
        check_f32_contiguous("cross_gram", z, x, invs2, gamma2)
    return (H, O, M, B)


def cost(z, x, invs2, gamma2) -> Cost:
    """Every (i, b) pair's D-long product (2 H O M B D) in 3xTF32, the
    inputs read once and the output written once."""
    (O, M, D), (B, _), (H, _) = z, x, invs2
    return Cost(2 * H * O * M * B * D, 4 * (O * M * D + B * D + H * D + H + H * O * M * B),
                "3xtf32")


def _cpu(z, x, invs2, gamma2):
    _check(z, x, invs2, gamma2)
    return cross_gram_plain(z, x, invs2, gamma2)


def _cuda(z, x, invs2, gamma2):
    H, O, M, B = _check(z, x, invs2, gamma2)
    on_cpu(z, x, invs2, gamma2)  # one device
    out = torch.empty((H, O, M, B), device=z.device, dtype=torch.float32)
    launch(
        "vargp_cross_gram", z.device, z.data_ptr(), x.data_ptr(), invs2.data_ptr(),
        gamma2.data_ptr(), out.data_ptr(), H, O, M, B, z.shape[-1],
    )
    return out


def _fake(z, x, invs2, gamma2):
    on_cpu(z, x, invs2, gamma2)  # refuses meta tensors and mixed devices
    return z.new_empty(_check(z, x, invs2, gamma2), dtype=result_dtype(z, x, invs2, gamma2))


cross_gram_op = kernel_op("cross_gram", "(Tensor z, Tensor x, Tensor invs2, Tensor gamma2) -> Tensor",
                          cpu=_cpu, cuda=_cuda, fake=_fake, cost=cost)


def cross_gram(z: torch.Tensor, x: torch.Tensor, invs2: torch.Tensor,
               gamma2: torch.Tensor) -> torch.Tensor:
    """K[h, o, i, b] = gamma2[h] exp(-0.5 sum_d invs2[h, d] (z[o,i,d] - x[b,d])^2)."""
    return cross_gram_op(z, x, invs2, gamma2)

