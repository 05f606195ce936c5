"""The ELBO step and the on-device train block.

Counterpart of ``elbo_step``, ``make_device_train_fn`` and
``pad_dataset_to_device`` in ``vargp_tpu/train/loop.py``.  The ELBO is
beta * kl_hypers + kl_u + (n_train / sum(w)) * nll (experiments/vargp.py
of the reference); its gradient comes from ``models.vargp.loss``'s
backward and the update from ``train.optim``.

Randomness comes from one ``torch.Generator`` on the device: per epoch one
permutation of the padded dataset, per step the step's noise
(``draw_noise``), in the order ``block_draws`` gives.  The train block
keeps the dataset on the device and makes no host transfer between its
steps.  The packed scale factor stays row-major inside the block: the JAX
package's "filled" layout is a TPU gather workaround, bit-exact against
row-major.
"""

from dataclasses import dataclass

import numpy as np
import torch

from vargp_tpu_torch.models import vargp as V
from vargp_tpu_torch.ops.device import resolve_device
from vargp_tpu_torch.train.optim import Adam, Yogi, tree_leaves, tree_unflatten


@dataclass(frozen=True)
class TrainHyperparams:
    """The fields of the JAX package's ``TrainHyperparams`` that training
    reads so far (beta and the batch size are arguments of the steps)."""

    lr: float = 1e-2
    optimizer: str = "yogi"  # the reference's torch_optimizer.Yogi


def make_optimizer(hp: TrainHyperparams):
    if hp.optimizer == "yogi":
        return Yogi(hp.lr)
    if hp.optimizer == "adam":
        return Adam(hp.lr)
    raise ValueError(f"unknown optimizer {hp.optimizer!r}")


def draw_noise(gen: torch.Generator, cfg: V.VARGPConfig, n_prev: int,
               batch_size: int) -> dict:
    """One step's ``noise`` for ``loss``, standard normal from ``gen`` on
    its device: hyper samples, prefix draws (with a chain of n_prev
    tasks) and function samples, in that order."""
    H = 1 if cfg.map_est_hypers else cfg.n_var_samples
    n_v, O = cfg.n_var_samples, cfg.out_size

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=gen.device)

    noise = {"hyper_eps": normal(n_v, V._theta_size(cfg) + 1)}
    if n_prev:
        noise["prefix_eps"] = normal(n_v, H, O, n_prev * cfg.M)
    noise["lik_eps"] = normal(H, cfg.n_f, O, batch_size)
    return noise


def elbo_step(params, opt_state, prev, prior, x, y, w, noise, *,
              cfg: V.VARGPConfig, opt, beta: float, n_train, chain_mask=None,
              device=None):
    """One optimizer step on the ELBO.  Returns (params, opt_state, loss,
    (kl_hypers, kl_u, nll)), the loss and its pieces taken before the
    update and detached.  ``device=None`` means the card."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    with torch.enable_grad():
        klh, klu, nll = V.loss(p, prev, prior, x, y, noise, cfg, weights=w,
                               chain_mask=chain_mask, device=device)
        scale = n_train / torch.clamp(torch.sum(w), min=1.0)
        total = beta * klh + klu + scale * nll
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    # a leaf the loss does not read (log_logvar under MAP) has gradient 0
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    params, opt_state = opt.update(grads, opt_state, params)
    return params, opt_state, total.detach(), (klh.detach(), klu.detach(), nll.detach())


def block_draws(gen: torch.Generator, n_pad: int, batch_size: int, n_epochs: int,
                cfg: V.VARGPConfig, n_prev: int):
    """Yield (batch row indices, noise) for every step of a train block, in
    the order the block draws them from ``gen``."""
    steps = n_pad // batch_size
    for _ in range(n_epochs):
        perm = torch.randperm(n_pad, generator=gen, device=gen.device)
        for s in range(steps):
            yield perm[s * batch_size:(s + 1) * batch_size], draw_noise(
                gen, cfg, n_prev, batch_size
            )


def train_block(params, opt_state, prev, prior, chain_mask, n_train, data_x, data_y,
                data_w, gen: torch.Generator, *, cfg: V.VARGPConfig, opt, beta: float,
                batch_size: int, n_epochs: int, device=None):
    """``n_epochs`` epochs of ELBO steps over a dataset padded to a
    multiple of ``batch_size`` with zero-weight rows (``pad_dataset_to_device``).
    Returns (params, opt_state, losses (steps,), pieces (steps, 3)), all on
    the device."""
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, the block runs on {dev}")
    n_pad = data_x.shape[0]
    if n_pad % batch_size:
        raise ValueError(f"{n_pad} dataset rows are not a multiple of {batch_size}")
    losses, pieces = [], []
    for idx, noise in block_draws(gen, n_pad, batch_size, n_epochs, cfg, len(prev)):
        params, opt_state, loss, aux = elbo_step(
            params, opt_state, prev, prior, data_x[idx], data_y[idx], data_w[idx], noise,
            cfg=cfg, opt=opt, beta=beta, n_train=n_train, chain_mask=chain_mask, device=dev,
        )
        losses.append(loss)
        pieces.append(torch.stack(aux))
    return params, opt_state, torch.stack(losses), torch.stack(pieces)


def pad_dataset_to_device(data, targets, batch_size: int, n_rows: int | None = None,
                          *, device=None):
    """(x, y, w) on ``device`` (None means the card): the rows padded to a
    multiple of ``batch_size`` (or of ``n_rows`` when that is larger) with
    zero-weight rows."""
    n = len(data)
    n_pad = -(-n // batch_size) * batch_size
    if n_rows is not None:
        if n_rows < n:
            raise ValueError(f"n_rows={n_rows} is below the {n} rows of the data")
        n_pad = max(n_pad, -(-n_rows // batch_size) * batch_size)
    x = np.zeros((n_pad, np.shape(data)[1]), dtype=np.float32)
    y = np.zeros((n_pad,), dtype=np.int64)
    w = np.zeros((n_pad,), dtype=np.float32)
    x[:n], y[:n], w[:n] = data, targets, 1.0
    dev = resolve_device(device)
    return tuple(torch.from_numpy(a).to(dev) for a in (x, y, w))
