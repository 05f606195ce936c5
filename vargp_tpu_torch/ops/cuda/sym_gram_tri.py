"""K2: triangle-skip symmetric ARD-RBF Gram (``csrc/sym_gram_tri.cu``).

Replaces ``vargp_tpu/ops/pallas/rbf_gram.py::_sym_gram_4d_tri``.  The same
function as K1 (:func:`sym_gram_plain`), the JAX package's choice for
chains of S >= 512 rows.  The kernel computes each lower tile once on the
tensor cores in 3xTF32 (``csrc/rbf_mma.cuh``) and mirrors it: its output
is bitwise symmetric, and K1 runs the same design on smaller tiles with
the same arithmetic per entry, so the two agree bit for bit.  The operator
``vargp_torch::sym_gram_tri`` launches the kernel for CUDA tensors and
takes the plain version for CPU tensors.
"""

import torch

from vargp_tpu_torch.ops.cuda.build import kernel_op, launch, on_cpu, result_dtype
from vargp_tpu_torch.ops.cuda.sym_gram import SCHEMA, check_sym, sym_cost, sym_gram_plain


def _cpu(z, invs, gamma2):
    check_sym("sym_gram_tri", z, invs, gamma2)
    return sym_gram_plain(z, invs, gamma2)


def _cuda(z, invs, gamma2):
    H, O, M, _ = check_sym("sym_gram_tri", z, invs, gamma2)
    on_cpu(z, invs, gamma2)  # one device
    out = torch.empty((H, O, M, M), device=z.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    launch(
        "vargp_sym_gram_tri", z.device, z.data_ptr(), invs.data_ptr(),
        gamma2.data_ptr(), out.data_ptr(), H, O, M, z.shape[-1],
    )
    return out


def _fake(z, invs, gamma2):
    on_cpu(z, invs, gamma2)  # refuses meta tensors and mixed devices
    return z.new_empty(check_sym("sym_gram_tri", z, invs, gamma2),
                       dtype=result_dtype(z, invs, gamma2))


sym_gram_tri_op = kernel_op("sym_gram_tri", SCHEMA, cpu=_cpu, cuda=_cuda, fake=_fake,
                            cost=sym_cost)


def sym_gram_tri(z: torch.Tensor, invs: torch.Tensor,
                 gamma2: torch.Tensor) -> torch.Tensor:
    """K[h, o, i, j] = gamma2[h] exp(-0.5 sum_d invs[h, d]^2 (z[o,i,d] - z[o,j,d])^2)."""
    return sym_gram_tri_op(z, invs, gamma2)

