"""Likelihoods over GP marginals; counterpart of ``vargp_tpu/likelihoods``:
the MC softmax one of the classifiers and the Gaussian one of the
regression driver."""

from vargp_tpu_torch.likelihoods.gaussian import (
    GaussianLikParams,
    gaussian_loss,
    gaussian_predict,
    init_gaussian,
)
from vargp_tpu_torch.likelihoods.softmax import (
    softmax_loss,
    softmax_predict,
    softmax_sample_logits,
)

__all__ = [
    "GaussianLikParams",
    "gaussian_loss",
    "gaussian_predict",
    "init_gaussian",
    "softmax_loss",
    "softmax_predict",
    "softmax_sample_logits",
]
