"""Deep kernel (DKL): an MLP feature map under the RBF kernel.

Counterpart of ``vargp_tpu/kernels/deep.py``: phi = Linear(D, 256) / ReLU
/ Linear(256, 256) / ReLU / Linear(256, 64); the RBF kernel sees the 64
features, so its hyperparameters have 65 entries.  The MLP is a tree of
tensors like the rest of the parameters; its products are f32.
"""

from typing import NamedTuple, Sequence

import torch

from vargp_tpu_torch.kernels.rbf import gram

DEFAULT_HIDDEN = 256
DEFAULT_FEATURES = 64


class MLPParams(NamedTuple):
    weights: tuple  # per-layer (in, out) matrices
    biases: tuple  # per-layer (out,) vectors


def init_mlp(uniform: Sequence[torch.Tensor], in_size: int, hidden: int = DEFAULT_HIDDEN,
             feature_size: int = DEFAULT_FEATURES) -> MLPParams:
    """torch.nn.Linear's default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    from explicit U[0, 1) draws: ``uniform`` holds, layer by layer, the
    weight's (in, out) draw and then the bias's (out,) draw, the order in
    which the JAX package's ``init_mlp`` draws them.  Each draw u maps to
    max(-b, u * 2b - b), as ``jax.random.uniform`` maps its own."""
    dims = [in_size, hidden, hidden, feature_size]
    if len(uniform) != 2 * (len(dims) - 1):
        raise ValueError(f"init_mlp: {len(uniform)} draws, expected {2 * (len(dims) - 1)}")
    weights, biases = [], []
    for i in range(len(dims) - 1):
        w_u, b_u = uniform[2 * i], uniform[2 * i + 1]
        if w_u.shape != (dims[i], dims[i + 1]) or b_u.shape != (dims[i + 1],):
            raise ValueError(f"init_mlp: layer {i} draws {tuple(w_u.shape)}, {tuple(b_u.shape)}")
        bound = 1.0 / torch.sqrt(torch.tensor(float(dims[i]), device=w_u.device))
        weights.append(torch.clamp(w_u * (2.0 * bound) - bound, min=-bound))
        biases.append(torch.clamp(b_u * (2.0 * bound) - bound, min=-bound))
    return MLPParams(weights=tuple(weights), biases=tuple(biases))


def mlp_apply(params: MLPParams, x: torch.Tensor) -> torch.Tensor:
    """phi(x): the ReLU MLP over the trailing feature dim, in f32."""
    h = x
    n = len(params.weights)
    for i, (W, b) in enumerate(zip(params.weights, params.biases)):
        h = torch.matmul(h, W) + b
        if i < n - 1:
            h = torch.relu(h)
    return h


def deep_gram(phi: MLPParams, theta: torch.Tensor, x: torch.Tensor,
              y: torch.Tensor | None = None) -> torch.Tensor:
    """The RBF Gram on MLP features, through K5."""
    fx = mlp_apply(phi, x)
    fy = None if y is None else mlp_apply(phi, y)
    return gram(theta, fx, fy)
