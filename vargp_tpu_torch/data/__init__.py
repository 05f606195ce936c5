"""Task-stream data layer: numpy array datasets and fixed-shape batches.

A copy of ``vargp_tpu/data`` (numpy only): importing that package would
import JAX.  The JAX package's optional C++ gather and IDX parser
(``vargp_tpu/data/loader.py``) are left out; this is the numpy path that
package falls back to, with the same results.
"""

from vargp_tpu_torch.data.core import ArrayDataset, batch_iter, eval_batches
from vargp_tpu_torch.data.digits import load_digits_dataset
from vargp_tpu_torch.data.mnist import load_mnist, mnist_available, mnist_source
from vargp_tpu_torch.data.tasks import (
    apply_permutation,
    filter_by_class,
    make_permutations,
    split_train_val,
)
from vargp_tpu_torch.data.toy import make_toy_dataset

__all__ = [
    "ArrayDataset",
    "apply_permutation",
    "batch_iter",
    "eval_batches",
    "filter_by_class",
    "load_digits_dataset",
    "load_mnist",
    "make_permutations",
    "make_toy_dataset",
    "mnist_available",
    "mnist_source",
    "split_train_val",
]
