"""Numerical primitives of the sparse-GP math; counterpart
of ``vargp_tpu/gpmath``."""

from vargp_tpu_torch.gpmath.conditional import (
    ARPosterior,
    MarginalCache,
    ar_joint_posterior,
    ar_joint_posterior_factored,
    ar_joint_posterior_fast,
    gp_cond,
    linear_joint,
    linear_marginal_diag,
    whitened_marginal_diag,
    whitened_marginal_diag_factored,
)
from vargp_tpu_torch.gpmath.linalg import (
    DEFAULT_JITTER,
    add_jitter,
    chol_solve,
    cholesky,
    mm,
    mmt,
    mtm,
    rev_cholesky,
    sym_cholesky,
    tri_inv,
    tri_solve,
)
from vargp_tpu_torch.gpmath.mvn import diag_normal_kl, mvn_kl, mvn_log_prob, mvn_sample
from vargp_tpu_torch.gpmath.tril import mat2trilvec, tril_dim, tril_indices, tril_size, vec2tril

__all__ = [
    "ARPosterior",
    "DEFAULT_JITTER",
    "MarginalCache",
    "add_jitter",
    "ar_joint_posterior",
    "ar_joint_posterior_factored",
    "ar_joint_posterior_fast",
    "chol_solve",
    "cholesky",
    "diag_normal_kl",
    "gp_cond",
    "linear_joint",
    "linear_marginal_diag",
    "mat2trilvec",
    "mm",
    "mmt",
    "mtm",
    "mvn_kl",
    "mvn_log_prob",
    "mvn_sample",
    "rev_cholesky",
    "sym_cholesky",
    "tri_inv",
    "tri_solve",
    "tril_dim",
    "tril_indices",
    "tril_size",
    "vec2tril",
    "whitened_marginal_diag",
    "whitened_marginal_diag_factored",
]
