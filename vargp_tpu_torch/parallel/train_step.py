"""Sharded training and prediction steps.

Counterpart of ``vargp_tpu/parallel/train_step.py``.  The update math is
not written again: each function here wraps ``train.loop.elbo_step`` /
``train_block`` / the loop's prediction, which take the mesh and add only
the placement and the collectives (``train/loop.py``: the gather of the
function samples' moments over "model" at the softmax, the loss pieces'
sums, the gradients' sums).  Each rank passes its own shards
(``shard_params``, ``shard_batch``) and the step's whole noise, drawn
alike on every rank; the kernels run on the rank's blocks.
"""

import torch

from vargp_tpu_torch.models import vargp as V
from vargp_tpu_torch.train.loop import elbo_step, predict_probs, train_block


def make_sharded_update_fn(cfg: V.VARGPConfig, opt, beta: float, n_train, mesh):
    """``update(params, opt_state, prev, prior, x, y, w, noise,
    chain_mask=None)``: one ELBO step on this rank's shards and rows;
    returns (params, opt_state, loss, (kl_hypers, kl_u, nll)), the loss
    and pieces the whole job's.  Supports the padded chain
    (``chain_mask``)."""

    def update(params, opt_state, prev, prior, x, y, w, noise, chain_mask=None):
        return elbo_step(params, opt_state, prev, prior, x, y, w, noise, cfg=cfg, opt=opt,
                         beta=beta, n_train=n_train, chain_mask=chain_mask,
                         device=mesh.device, mesh=mesh)

    return update


def make_sharded_device_train_fn(cfg: V.VARGPConfig, opt, beta: float, batch_size: int,
                                 n_epochs: int, mesh):
    """The training block (``train.loop.train_block``: ``n_epochs`` epochs
    of steps over a dataset every rank holds whole), sharded over the
    mesh: each rank takes its rows of every minibatch and its classes'
    parameters.  ``run(params, opt_state, prev, prior, chain_mask,
    n_train, data_x, data_y, data_w, gen, draws=None)``."""

    def run(params, opt_state, prev, prior, chain_mask, n_train, data_x, data_y, data_w, gen,
            draws=None):
        return train_block(params, opt_state, prev, prior, chain_mask, n_train, data_x, data_y,
                           data_w, gen, cfg=cfg, opt=opt, beta=beta, batch_size=batch_size,
                           n_epochs=n_epochs, device=mesh.device, draws=draws, mesh=mesh)

    return run


def make_sharded_predict_fn(cfg: V.VARGPConfig, mesh):
    """``predict(params, prev, x, noise, chain_mask=None)``: the class
    probabilities (B / dp, out_size) of this rank's rows ``x``, from the
    whole batch's noise."""

    def predict(params, prev, x, noise, chain_mask=None):
        with torch.no_grad():
            return predict_probs(params, prev, x, noise, cfg, chain_mask=chain_mask,
                                 device=mesh.device, mesh=mesh)

    return predict
