"""Array dataset and fixed-shape batching (copy of ``vargp_tpu/data/core.py``).

A dataset is an immutable pair of numpy arrays; batching yields
fixed-shape (x, y, weights) triples where the last partial minibatch is
padded and zero-weighted, so every batch of a run has one shape.
"""

from typing import Iterator, NamedTuple

import numpy as np


class ArrayDataset(NamedTuple):
    data: np.ndarray  # (N, D) float32
    targets: np.ndarray  # (N,) int32

    def __len__(self) -> int:
        return self.data.shape[0]

    def select(self, idx: np.ndarray) -> "ArrayDataset":
        return ArrayDataset(self.data[idx], self.targets[idx])


class Batch(NamedTuple):
    x: np.ndarray  # (B, D)
    y: np.ndarray  # (B,)
    w: np.ndarray  # (B,) 1.0 for real rows, 0.0 for padding


def batch_iter(
    ds: ArrayDataset,
    batch_size: int,
    rng: np.random.Generator | None = None,
    shuffle: bool = True,
) -> Iterator[Batch]:
    """Shuffled fixed-shape minibatches covering the whole dataset; the final
    partial batch is padded with zero rows and zero weights."""
    n = len(ds)
    order = (rng or np.random.default_rng()).permutation(n) if shuffle else np.arange(n)
    data, targets = ds.data[order], ds.targets[order]
    for start in range(0, n, batch_size):
        stop = min(start + batch_size, n)
        k = stop - start
        if k == batch_size:
            yield Batch(
                data[start:stop], targets[start:stop],
                np.ones(batch_size, dtype=np.float32),
            )
        else:
            x = np.zeros((batch_size, data.shape[1]), dtype=data.dtype)
            y = np.zeros((batch_size,), dtype=targets.dtype)
            w = np.zeros((batch_size,), dtype=np.float32)
            x[:k], y[:k], w[:k] = data[start:stop], targets[start:stop], 1.0
            yield Batch(x, y, w)


def eval_batches(ds: ArrayDataset, batch_size: int) -> Iterator[Batch]:
    """Deterministic fixed-shape batches for evaluation."""
    yield from batch_iter(ds, batch_size, shuffle=False)
