"""Continual-learning task-stream transforms (copy of
``vargp_tpu/data/tasks.py``): class filters, the train/validation split
and the pixel permutations, as pure functions on ``ArrayDataset``."""

import numpy as np

from vargp_tpu_torch.data.core import ArrayDataset


def filter_by_class(ds: ArrayDataset, class_list=None) -> ArrayDataset:
    """Keep rows whose target is in class_list (None/empty keeps all)."""
    if not class_list:
        return ds
    mask = np.isin(ds.targets, np.asarray(list(class_list)))
    return ds.select(np.flatnonzero(mask))


def split_train_val(
    ds: ArrayDataset, n_val: int, rng: np.random.Generator
) -> tuple[ArrayDataset, ArrayDataset]:
    """Random train/val split; n_val=0 means no validation rows."""
    idx = rng.permutation(len(ds))
    cut = len(idx) - n_val
    return ds.select(idx[:cut]), ds.select(idx[cut:])


def make_permutations(n_tasks: int, dim: int, rng: np.random.Generator):
    """Pixel permutations per task; task 0 is the identity."""
    perms = [np.arange(dim)]
    perms += [rng.permutation(dim) for _ in range(n_tasks - 1)]
    return perms


def apply_permutation(ds: ArrayDataset, perm: np.ndarray) -> ArrayDataset:
    return ArrayDataset(ds.data[:, perm], ds.targets)

