"""vargp_tpu_torch: the VAR-GP framework on PyTorch and CUDA (Hopper).

A port of ``vargp_tpu`` with the same module layout.  Its entry points run
on the card unless the caller asks for the CPU; the hand-written kernels
live in ``ops/cuda`` (wrappers) and ``csrc`` (CUDA C++ for sm_90a).  This
package imports torch, numpy and the standard library only.
"""

import torch

# The factorised path is f32 "highest" in the JAX package: no TF32 in any
# product or convolution.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

# train first: models.vargp reads train.optim, and train.loop reads models
from vargp_tpu_torch import train  # noqa: E402, I001
from vargp_tpu_torch import data, gpmath, kernels, likelihoods, models  # noqa: E402

__all__ = [
    "gpmath",
    "kernels",
    "likelihoods",
    "models",
    "train",
    "data",
    "__version__",
]
