"""Task-level training of the global continual SVGP: the ELBO, the
evaluation and ``train_task``.

Counterpart of ``vargp_tpu/train/loop_global.py``.  The ELBO is
beta * kl_hypers + kl_u - u_prev_reg + (n_train / sum(w)) * nll.  The
gradient step, the train block, the blocks' schedule, the dataset, the
optimizer, the evaluation stacks and the evaluate-log-stop loop are
``train.loop``'s; the model grows its inducing set from task to task, so
there is no padded chain.

Randomness comes from one draw source (``GlobalDraws`` over the task's
``torch.Generator`` by default): the inducing rows (or the rows added to
the previous task's), the initial parameters' noise, each block's
permutations and per-step noise, and each evaluation's noise.  The
evaluation follows the JAX package's rule for this model: every batch of
a split draws its own hyper samples and function samples (the JAX scan
folds the batch index into the key), and batch i of the train,
validation and test splits share their draws (one key an evaluation).
"""

import numpy as np
import torch

from vargp_tpu_torch.data.core import ArrayDataset
from vargp_tpu_torch.models import global_svgp as G
from vargp_tpu_torch.models.vargp import eval_budget_cfg
from vargp_tpu_torch.ops.device import check_on_device, resolve_device
from vargp_tpu_torch.train.loop import (
    GeneratorDraws,
    TrainHyperparams,
    count_correct,
    fit,
    gradient_step,
    make_optimizer,
    pad_dataset_to_device,
    split_accuracies,
    stack_splits,
    step_block,
)


def draw_noise(gen: torch.Generator, cfg: G.GlobalSVGPConfig, M_prev: int | None,
               batch_size: int) -> dict:
    """One step's ``noise`` for ``G.loss``, standard normal from ``gen`` on
    its device: hyper samples, function samples and, with a previous task
    of M_prev inducing rows, the regulariser's draws, in that order."""
    H = 1 if cfg.map_est_hypers else cfg.n_var_samples
    n_v, O = cfg.n_var_samples, cfg.out_size

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=gen.device)

    noise = {"hyper_eps": normal(n_v, cfg.in_size + 1),
             "lik_eps": normal(H, cfg.n_f, O, batch_size)}
    if M_prev is not None:
        noise["reg_eps"] = normal(n_v, H, O, M_prev)
    return noise


def elbo(params, prev, prior, x, y, w, noise, *, cfg: G.GlobalSVGPConfig, beta: float, n_train,
         device=None):
    """``train.loop.gradient_step``'s objective: (beta * kl_hypers + kl_u -
    u_prev_reg + (n_train / sum(w)) * nll, its four pieces)."""
    pieces = G.loss(params, prev, prior, x, y, noise, cfg, weights=w, device=device)
    klh, klu, upr, nll = pieces
    scale = n_train / torch.clamp(torch.sum(w), min=1.0)
    return beta * klh + klu - upr + scale * nll, pieces


def make_device_eval_fn_global(cfg: G.GlobalSVGPConfig, hp: TrainHyperparams | None = None):
    """Whole-split accuracy: ``eval_acc(params, prev, xs, ys, ws, draws,
    device=None)`` over stacked batches xs (K, B, D), ys / ws (K, B)
    returns (correct count, weight count), tensors on the device.

    ``draws`` holds hyper_eps (K', n_v, D+1) and lik_eps (K', H, n_f, O, B)
    with K' >= K: batch i predicts with its own draws (``[i]``), at the
    budgets of ``hp`` (``eval_n_f``, ``eval_n_var_samples``;
    ``eval_resample_per_batch`` is not read: this model always draws per
    batch).  The count accumulates on the device (``count_correct``: NaN
    after a non-finite probability)."""
    n_f = hp.eval_n_f if hp else None
    n_v = hp.eval_n_var_samples if hp else None

    def eval_acc(params, prev, xs, ys, ws, draws, *, device=None):
        dev = resolve_device(device)
        check_on_device(dev, xs, ys, ws, *draws.values())
        with torch.no_grad():
            probs = (G.predict(params, prev, xs[i], {"hyper_eps": draws["hyper_eps"][i],
                                                     "lik_eps": draws["lik_eps"][i]},
                               cfg, n_f=n_f, n_var_samples=n_v, device=dev)
                     for i in range(xs.shape[0]))
            return count_correct(probs, ys, ws), torch.sum(ws)

    return eval_acc


class GlobalDraws(GeneratorDraws):
    """``train_task``'s draws for the global model from one
    ``torch.Generator``: ``inducing`` (task 0's rows), ``grow`` (the rows
    added to the previous task's), ``init``, ``block`` (the global noise,
    with the regulariser's draws when a previous task of M_prev rows is
    given) and ``evaluation`` (per batch: ``GeneratorDraws.evaluation``
    with ``per_batch=True``)."""

    draw_noise = staticmethod(draw_noise)

    def grow(self, prev_z: torch.Tensor, data: torch.Tensor, M: int, out_size: int):
        return G.grow_inducing(self.gen, prev_z, data, M, out_size)


def train_task(gen, task_id: int, train_set: ArrayDataset, val_set: ArrayDataset,
               test_set: ArrayDataset, cfg: G.GlobalSVGPConfig, hp: TrainHyperparams,
               prev_state: G.GlobalSVGPParams | None = None, logger=None,
               seed: int | None = None, *, device=None, draws=None):
    """Train one task of the global model; returns (best_params, info).

    ``gen`` is the task's ``torch.Generator`` on ``device`` (None means the
    card), or an int seed for one; ``draws`` replaces the draw source
    (``GlobalDraws(gen)``).  ``prev_state`` is the previous task's best
    parameters: it is frozen into the regulariser's ``GlobalPrev``, its
    inducing rows are kept (``cfg.M`` larger adds rows), and its kernel
    posterior is the new kernel prior.  The task trains and evaluates
    through ``train.loop.fit`` (the JAX package's tags, ``u_prev_reg``
    included), whose ``info`` it returns.  ``seed`` is the JAX signature's
    data seed, read only by the per-minibatch mode, which is not ported."""
    if not hp.scan_epoch:
        raise NotImplementedError(
            "scan_epoch=False (one host dispatch per minibatch) is not ported: "
            "train blocks are the port's only mode")
    dev = resolve_device(device)
    if draws is None:
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(gen))
        draws = GlobalDraws(gen)

    x_train = torch.from_numpy(np.ascontiguousarray(train_set.data)).to(dev)
    if prev_state is not None:
        prev = G.freeze_task(prev_state)
        z_init = draws.grow(prev_state.z, x_train, cfg.M, cfg.out_size)
        kernel_prior_from = prev_state.kernel
    else:
        prev, kernel_prior_from = None, None
        z_init = draws.inducing(x_train, cfg.M, cfg.out_size)
    M_prev = None if prev is None else prev.z.shape[-2]
    init = draws.init(cfg, with_phi=False)
    params, prior = G.init_params(init["kernel_eps"], init["u_eps"], z_init, cfg,
                                  kernel_prior_from=kernel_prior_from)

    opt = make_optimizer(hp)
    opt_state = opt.init(params)
    n_train = torch.tensor(float(len(train_set)), device=dev)
    data_x, data_y, data_w = pad_dataset_to_device(train_set.data, train_set.targets,
                                                   hp.batch_size, device=dev)
    n_pad = data_x.shape[0]

    eval_acc = make_device_eval_fn_global(cfg, hp)
    cfg_eval = eval_budget_cfg(cfg, n_f=hp.eval_n_f, n_var_samples=hp.eval_n_var_samples)
    stacks, n_eval_batches = stack_splits(hp, (train_set, val_set, test_set), device=dev)

    def step(params, opt_state, x, y, w, noise):
        return gradient_step(params, opt_state, lambda p: elbo(
            p, prev, prior, x, y, w, noise, cfg=cfg, beta=hp.beta, n_train=n_train, device=dev),
            opt)

    def block(params, opt_state, n_epochs):
        return step_block(step, params, opt_state,
                          draws.block(n_pad, hp.batch_size, n_epochs, cfg, M_prev),
                          data_x, data_y, data_w)

    def evaluate(params):
        ev = draws.evaluation(cfg_eval, n_eval_batches, hp.batch_size, True)
        return split_accuracies(
            lambda xs, ys, ws: eval_acc(params, prev, xs, ys, ws, ev, device=dev)[0],
            stacks, task_id)

    info = fit(params, opt_state, block, evaluate, hp, task_id, n_pad // hp.batch_size,
               ("kl_hypers", "kl_u", "u_prev_reg", "lik"), logger)
    return info["params"], info
