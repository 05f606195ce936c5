"""K2: triangle-skip symmetric ARD-RBF Gram (``csrc/sym_gram_tri.cu``).

Replaces ``vargp_tpu/ops/pallas/rbf_gram.py::_sym_gram_4d_tri``.  The same
function as K1 (:func:`sym_gram_plain`), the JAX package's choice for
chains of S >= 512 rows.  The kernel computes each lower tile once on the
tensor cores in 3xTF32 (``csrc/rbf_mma.cuh``) and mirrors it: its output
is bitwise symmetric, and K1 runs the same design on smaller tiles with
the same arithmetic per entry, so the two agree bit for bit.  A CUDA tensor launches the kernel; a CPU tensor takes the
plain version.
"""

import torch

from vargp_tpu_torch.ops.cuda.build import check_f32_contiguous, launch, on_cpu
from vargp_tpu_torch.ops.cuda.sym_gram import sym_gram_plain


def sym_gram_tri(z: torch.Tensor, invs: torch.Tensor,
                 gamma2: torch.Tensor) -> torch.Tensor:
    """K[h, o, i, j] = gamma2[h] exp(-0.5 sum_d invs[h, d]^2 (z[o,i,d] - z[o,j,d])^2)."""
    if on_cpu(z, invs, gamma2):
        return sym_gram_plain(z, invs, gamma2)
    O, M, D = z.shape
    H = invs.shape[0]
    if invs.shape != (H, D) or gamma2.shape != (H,):
        raise ValueError(
            f"sym_gram_tri: z {tuple(z.shape)}, invs {tuple(invs.shape)}, "
            f"gamma2 {tuple(gamma2.shape)}"
        )
    if H * O > 65535:
        raise ValueError(f"sym_gram_tri: H*O = {H * O} exceeds the grid's y limit")
    check_f32_contiguous("sym_gram_tri", z, invs, gamma2)
    out = torch.empty((H, O, M, M), device=z.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    launch(
        "vargp_sym_gram_tri", z.device, z.data_ptr(), invs.data_ptr(),
        gamma2.data_ptr(), out.data_ptr(), H, O, M, D,
    )
    sym_gram_tri.launches += 1
    return out


sym_gram_tri.launches = 0
