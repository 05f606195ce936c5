"""Toy 2-D 4-cluster dataset (copy of ``vargp_tpu/data/toy.py``): four
Gaussian clusters of 50 points, classes 0..3, shifted by X[:, 1] -= 1,
X[:, 0] -= 0.5, drawn from an explicit numpy Generator."""

import numpy as np

from vargp_tpu_torch.data.core import ArrayDataset


def make_toy_dataset(seed: int = 0, n_per_class: int = 50) -> ArrayDataset:
    rng = np.random.default_rng(seed)
    n = n_per_class

    x1 = np.stack(
        [0.8 + 0.4 * rng.standard_normal(n), 1.5 + 0.4 * rng.standard_normal(n)],
        axis=-1,
    )
    x2 = np.stack(
        [0.5 + 0.6 * rng.standard_normal(n), -0.2 - 0.1 * rng.standard_normal(n)],
        axis=-1,
    )
    x3 = np.stack(
        [2.5 - 0.1 * rng.standard_normal(n), 1.0 + 0.6 * rng.standard_normal(n)],
        axis=-1,
    )
    cov = np.array([[0.2, 0.1], [0.1, 0.1]])
    x4 = rng.multivariate_normal([-0.5, 1.5], cov, size=n)

    X = np.concatenate([x1, x2, x3, x4], axis=0).astype(np.float32)
    X[:, 1] -= 1.0
    X[:, 0] -= 0.5
    Y = np.repeat(np.arange(4, dtype=np.int32), n)
    return ArrayDataset(X, Y)
