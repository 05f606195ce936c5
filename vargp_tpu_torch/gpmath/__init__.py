"""Numerical primitives of the sparse-GP math; counterpart
of ``vargp_tpu/gpmath``."""

from vargp_tpu_torch.gpmath.conditional import (
    ar_joint_posterior_factored,
    whitened_marginal_diag_factored,
)
from vargp_tpu_torch.gpmath.linalg import DEFAULT_JITTER, add_jitter, mm, mmt, mtm, tri_inv
from vargp_tpu_torch.gpmath.mvn import diag_normal_kl, mvn_kl
from vargp_tpu_torch.gpmath.tril import mat2trilvec, tril_dim, tril_size, vec2tril

__all__ = [
    "DEFAULT_JITTER",
    "add_jitter",
    "ar_joint_posterior_factored",
    "diag_normal_kl",
    "mat2trilvec",
    "mm",
    "mmt",
    "mtm",
    "mvn_kl",
    "tri_inv",
    "tril_dim",
    "tril_size",
    "vec2tril",
    "whitened_marginal_diag_factored",
]
