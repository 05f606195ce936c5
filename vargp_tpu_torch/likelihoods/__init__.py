"""Likelihoods over GP marginals; counterpart of ``vargp_tpu/likelihoods``
(the softmax one only: the Gaussian one is not ported yet)."""

from vargp_tpu_torch.likelihoods.softmax import (
    softmax_loss,
    softmax_predict,
    softmax_sample_logits,
)

__all__ = ["softmax_loss", "softmax_predict", "softmax_sample_logits"]
