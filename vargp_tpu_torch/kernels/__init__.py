"""Kernels with variational hyperparameters; counterpart of
``vargp_tpu/kernels`` (RBF-ARD only: the deep kernel is not ported yet)."""

from vargp_tpu_torch.kernels.rbf import (
    RBFParams,
    RBFPrior,
    cross_gram,
    default_prior,
    gram_diag,
    init_rbf,
    kl_hypers,
    sample_hypers,
    sym_gram,
)

__all__ = [
    "RBFParams",
    "RBFPrior",
    "cross_gram",
    "default_prior",
    "gram_diag",
    "init_rbf",
    "kl_hypers",
    "sample_hypers",
    "sym_gram",
]
