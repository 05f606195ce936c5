"""Split-Digits data (copy of ``vargp_tpu/data/digits.py``): scikit-learn's
bundled 1,797 real 8x8 handwritten digits, scaled to [0, 1], with a
deterministic stratified split of 36 test rows per class.  scikit-learn is
imported only when the data is loaded, so nothing else needs it."""

import numpy as np

from vargp_tpu_torch.data.core import ArrayDataset

_N_TEST_PER_CLASS = 36  # ~20% of ~180 per class -> 360 test samples


def _load_raw():
    from sklearn.datasets import load_digits

    X, y = load_digits(return_X_y=True)
    return (X / 16.0).astype(np.float32), y.astype(np.int32)


def load_digits_dataset(train: bool = True, seed: int = 0) -> ArrayDataset:
    """Stratified deterministic train/test split of the 1,797 digits."""
    X, y = _load_raw()
    rng = np.random.default_rng(seed)
    test_mask = np.zeros(len(y), dtype=bool)
    for c in range(10):
        idx = np.flatnonzero(y == c)
        test_mask[rng.permutation(idx)[:_N_TEST_PER_CLASS]] = True
    mask = ~test_mask if train else test_mask
    return ArrayDataset(X[mask], y[mask])
