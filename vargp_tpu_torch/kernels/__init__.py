"""Kernels with variational hyperparameters; counterpart of
``vargp_tpu/kernels``: RBF-ARD, and the deep (DKL) variant that applies an
MLP feature map first."""

from vargp_tpu_torch.kernels.rbf import (
    RBFParams,
    RBFPrior,
    cross_gram,
    default_prior,
    gram,
    gram_diag,
    init_rbf,
    kl_hypers,
    sample_hypers,
    sym_gram,
)
from vargp_tpu_torch.kernels.deep import MLPParams, deep_gram, init_mlp, mlp_apply

__all__ = [
    "MLPParams",
    "RBFParams",
    "RBFPrior",
    "cross_gram",
    "deep_gram",
    "default_prior",
    "gram",
    "gram_diag",
    "init_mlp",
    "init_rbf",
    "kl_hypers",
    "mlp_apply",
    "sample_hypers",
    "sym_gram",
]
