"""Monte-Carlo multiclass softmax likelihood.

Counterpart of ``vargp_tpu/likelihoods/softmax.py``.  The function-sample
noise ``eps`` (n_hypers, n_f, out_size, B) is an argument.
"""

import torch


def softmax_sample_logits(mu: torch.Tensor, var: torch.Tensor,
                          eps: torch.Tensor) -> torch.Tensor:
    """f = mu + sqrt(var) eps per function sample, log-softmax over classes.
    mu, var: (H, O, B) -> (H, n_f, O, B)."""
    f = mu[:, None] + torch.sqrt(var)[:, None] * eps
    return torch.log_softmax(f, dim=-2)


def softmax_loss(mu: torch.Tensor, var: torch.Tensor, y: torch.Tensor,
                 eps: torch.Tensor, weights: torch.Tensor | None = None) -> torch.Tensor:
    """Expected NLL: mean over (hypers, function samples), sum over the
    batch.  ``weights`` (B,) masks padded batch rows."""
    log_p = softmax_sample_logits(mu, var, eps)  # (H, F, O, B)
    picked = torch.gather(
        log_p, -2, y.reshape(1, 1, 1, -1).expand(*log_p.shape[:2], 1, -1)
    )[..., 0, :]  # (H, F, B)
    per_example = torch.mean(picked, dim=(0, 1))
    if weights is not None:
        per_example = per_example * weights
    return -torch.sum(per_example)


def softmax_predict(mu: torch.Tensor, var: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Predictive class probabilities (B, O): the MC average of the softmax
    over all n_hypers * n_f samples, through logsumexp."""
    log_p = softmax_sample_logits(mu, var, eps)
    n = log_p.shape[0] * log_p.shape[1]
    flat = log_p.reshape(-1, *log_p.shape[-2:])
    return (torch.exp(torch.logsumexp(flat, dim=0)) / n).T
