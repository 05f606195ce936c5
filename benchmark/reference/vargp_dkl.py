"""Plain PyTorch reference of VAR-GP under the deep kernel (DKL): the
predictive class probabilities with the RBF kernel on the features of an
MLP.

Written from the published model (Kapoor, Karaletsos & Bui, ICML 2021,
arXiv:2006.05468; uber-research/vargp ``var_gp/kernels.py:80-96``,
``DeepRBFKernel``) and nothing of the program: phi = Linear(D, 256),
ReLU, Linear(256, 256), ReLU, Linear(256, 64), and the ARD RBF kernel on
phi's 64 features, so the hyperparameters have 65 entries.  phi is applied
here in ``Arith``'s precision: float64 for the reference, and for the
control float32 whose three products round their operands to TF32, as the
rest of the control's products do.  The features are then handed, as the
inducing rows and the batch, to ``reference/vargp.py``'s ``posterior`` and
``marginal`` (through its ``predict``), unchanged.

Departures from ``DeepRBFKernel``, none of which changes a value:

- a layer is y = x W + b with W stored (in, out), where ``torch.nn.Linear``
  stores (out, in) and computes x W^T + b;
- phi is applied once to each class's inducing rows and once to the batch,
  which every class shares; ``DeepRBFKernel.compute`` applies it to the
  arguments of each Gram it computes.
"""

import torch

from benchmark.reference import vargp as R

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def features(arith: R.Arith, phi: list, x: torch.Tensor) -> torch.Tensor:
    """phi(x) in ``arith``'s precision; ``phi`` is [W0, b0, W1, b1, W2, b2],
    each W (in, out)."""
    n = len(phi) // 2
    h = x.to(arith.dtype)
    for i in range(n):
        h = R.mm(arith, h, phi[2 * i].to(arith.dtype)) + phi[2 * i + 1].to(arith.dtype)
        if i < n - 1:
            h = torch.relu(h)
    return h


def predict(arith: R.Arith, current: dict, chain: list, phi: list, x: torch.Tensor,
            noise: dict, jitter: float, hyper_block: int = 4) -> torch.Tensor:
    """Class probabilities (B, O): ``reference/vargp.py``'s ``predict`` on
    phi's features of the inducing rows (``z`` of ``current`` and of each
    entry of ``chain``, which the reference's ``posterior`` reads) and of
    the batch x (B, D)."""
    current = dict(current, z=features(arith, phi, current["z"]))
    chain = [dict(t, z=features(arith, phi, t["z"])) for t in chain]
    return R.predict(arith, current, chain, features(arith, phi, x), noise, jitter,
                     hyper_block)
