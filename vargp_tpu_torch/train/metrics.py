"""Evaluation metrics; counterpart of ``vargp_tpu/train/metrics.py``.

``predict_fn(x) -> (B, out)`` probabilities is any predictor taking a
numpy batch; it may return a tensor on any device.  The helpers stream
fixed-shape padded batches, mask the padding and refuse NaN predictions.
"""

import numpy as np
import torch

from vargp_tpu_torch.data.core import ArrayDataset, eval_batches


def _probs(predict_fn, x) -> np.ndarray:
    p = predict_fn(x)
    if isinstance(p, torch.Tensor):
        p = p.detach().cpu().numpy()
    p = np.asarray(p)
    assert not np.isnan(p).any(), "Found NaNs"
    return p


def compute_accuracy(ds: ArrayDataset, predict_fn, batch_size: int = 512) -> float:
    """Top-1 accuracy over the dataset."""
    count = 0
    for b in eval_batches(ds, batch_size):
        hits = (_probs(predict_fn, b.x).argmax(axis=-1) == b.y) & (b.w > 0)
        count += int(hits.sum())
    return count / len(ds)


def compute_acc_ent(ds: ArrayDataset, predict_fn, batch_size: int = 512):
    """(accuracy, mean predictive entropy in nats) over the dataset."""
    total_corr = 0
    total_ent = 0.0
    for b in eval_batches(ds, batch_size):
        probs = _probs(predict_fn, b.x)
        hits = (probs.argmax(axis=-1) == b.y) & (b.w > 0)
        total_corr += int(hits.sum())
        ent = -np.sum(np.where(probs > 0, probs * np.log(probs), 0.0), axis=-1)
        total_ent += float((ent * b.w).sum())
    n = len(ds)
    return total_corr / n, total_ent / n


def compute_bwt(acc_mat: np.ndarray) -> float:
    """Backward transfer: mean(last row - diagonal), the final task
    excluded."""
    acc_mat = np.asarray(acc_mat)
    assert acc_mat.ndim == 2 and acc_mat.shape[0] == acc_mat.shape[1]
    return float((acc_mat[-1][:-1] - np.diagonal(acc_mat)[:-1]).mean())
