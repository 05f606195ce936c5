"""Task-level training of the global continual SVGP: the ELBO step, the
on-device train block, the evaluation and ``train_task``.

Counterpart of ``vargp_tpu/train/loop_global.py``.  The ELBO is
beta * kl_hypers + kl_u - u_prev_reg + (n_train / sum(w)) * nll.  The
dataset, the optimizer, the evaluation stacks and the early stopper are
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

import time

import numpy as np
import torch

from vargp_tpu_torch.data.core import ArrayDataset
from vargp_tpu_torch.models import global_svgp as G
from vargp_tpu_torch.models.vargp import eval_budget_cfg
from vargp_tpu_torch.ops.device import check_on_device, resolve_device
from vargp_tpu_torch.train.loop import (
    GeneratorDraws,
    TrainHyperparams,
    _eval_batches,
    make_optimizer,
    pad_dataset_to_device,
    stack_eval_set,
)
from vargp_tpu_torch.train.optim import tree_leaves, tree_unflatten
from vargp_tpu_torch.train.stopper import EarlyStopper


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


def elbo_step(params, opt_state, prev, prior, x, y, w, noise, *, cfg: G.GlobalSVGPConfig, opt,
              beta: float, n_train, device=None):
    """One optimizer step on the global ELBO.  Returns (params, opt_state,
    loss, (kl_hypers, kl_u, u_prev_reg, nll)), the loss and its pieces
    taken before the update and detached.  ``device=None`` means the card."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    with torch.enable_grad():
        pieces = G.loss(tree_unflatten(params, leaves), prev, prior, x, y, noise, cfg, weights=w,
                        device=device)
        klh, klu, upr, nll = pieces
        scale = n_train / torch.clamp(torch.sum(w), min=1.0)
        total = beta * klh + klu - upr + scale * nll
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    # a leaf the loss does not read (log_logvar under MAP) has gradient 0
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    params, opt_state = opt.update(grads, opt_state, params)
    return params, opt_state, total.detach(), tuple(p.detach() for p in pieces)


def block_draws(gen: torch.Generator, n_pad: int, batch_size: int, n_epochs: int,
                cfg: G.GlobalSVGPConfig, M_prev: int | None):
    """Yield (batch row indices, noise) for every step of a train block, in
    the order the block draws them from ``gen``: per epoch a permutation,
    then each step's noise."""
    for _ in range(n_epochs):
        perm = torch.randperm(n_pad, generator=gen, device=gen.device)
        for s in range(n_pad // batch_size):
            yield perm[s * batch_size:(s + 1) * batch_size], draw_noise(gen, cfg, M_prev,
                                                                        batch_size)


def train_block_global(params, opt_state, prev, prior, n_train, data_x, data_y, data_w, draws,
                       *, cfg: G.GlobalSVGPConfig, opt, beta: float, device=None):
    """ELBO steps over a dataset padded with zero-weight rows
    (``pad_dataset_to_device``), one per (row indices, noise) of
    ``draws`` (``block_draws``).  The dataset stays on the device and no
    value is read back between steps.  Returns (params, opt_state, losses
    (steps,), pieces (steps, 4)), all on the device."""
    dev = resolve_device(device)
    losses, pieces = [], []
    for idx, noise in draws:
        params, opt_state, loss, aux = elbo_step(
            params, opt_state, prev, prior, data_x[idx], data_y[idx], data_w[idx], noise,
            cfg=cfg, opt=opt, beta=beta, n_train=n_train, device=dev)
        losses.append(loss)
        pieces.append(torch.stack(aux))
    return params, opt_state, torch.stack(losses), torch.stack(pieces)


def make_device_eval_fn_global(cfg: G.GlobalSVGPConfig, hp: TrainHyperparams | None = None):
    """Whole-split accuracy: ``eval_acc(params, prev, xs, ys, ws, draws,
    device=None)`` over stacked batches xs (K, B, D), ys / ws (K, B)
    returns (correct count, weight count), tensors on the device.

    ``draws`` holds hyper_eps (K', n_v, D+1) and lik_eps (K', H, n_f, O, B)
    with K' >= K: batch i predicts with its own draws (``[i]``), at the
    budgets of ``hp`` (``eval_n_f``, ``eval_n_var_samples``;
    ``eval_resample_per_batch`` is not read: this model always draws per
    batch).  The count and an "every probability finite" flag accumulate
    on the device; a non-finite probability makes the count NaN."""
    n_f = hp.eval_n_f if hp else None
    n_v = hp.eval_n_var_samples if hp else None

    def eval_acc(params, prev, xs, ys, ws, draws, *, device=None):
        dev = resolve_device(device)
        check_on_device(dev, xs, ys, ws, *draws.values())
        with torch.no_grad():
            correct = xs.new_zeros(())
            ok = torch.ones((), dtype=torch.bool, device=xs.device)
            for i in range(xs.shape[0]):
                noise = {"hyper_eps": draws["hyper_eps"][i], "lik_eps": draws["lik_eps"][i]}
                probs = G.predict(params, prev, xs[i], noise, cfg, n_f=n_f, n_var_samples=n_v,
                                  device=dev)
                hits = (torch.argmax(probs, dim=-1) == ys[i]).to(torch.float32) * ws[i]
                ok = ok & torch.all(torch.isfinite(probs))
                correct = correct + torch.sum(hits)
            correct = torch.where(ok, correct, torch.full_like(correct, float("nan")))
            return correct, torch.sum(ws)

    return eval_acc


class GlobalDraws(GeneratorDraws):
    """``train_task``'s draws for the global model from one
    ``torch.Generator``: ``inducing`` (task 0's rows), ``grow`` (the rows
    added to the previous task's), ``init``, ``block`` (the global noise,
    with the regulariser's draws when a previous task of M_prev rows is
    given) and ``evaluation`` (per batch: ``GeneratorDraws.evaluation``
    with ``per_batch=True``)."""

    def grow(self, prev_z: torch.Tensor, data: torch.Tensor, M: int, out_size: int):
        return G.grow_inducing(self.gen, prev_z, data, M, out_size)

    def block(self, n_pad: int, batch_size: int, n_epochs: int, cfg: G.GlobalSVGPConfig,
              M_prev: int | None):
        return block_draws(self.gen, n_pad, batch_size, n_epochs, cfg, M_prev)


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
    posterior is the new kernel prior.  Training runs in blocks of epochs
    that end on the evaluation cadence, each at most
    ``hp.max_steps_per_dispatch`` steps' worth of whole epochs; at each
    evaluation the four ELBO pieces and the three splits' accuracies are
    logged (the JAX package's tags, ``u_prev_reg`` included) and the
    validation accuracy goes to an ``EarlyStopper``.  ``seed`` is the JAX
    signature's data seed, read only by the per-minibatch mode, which is
    not ported.  ``info`` holds the best evaluation's params, acc_summary
    and step (its epoch), and the run's steps_per_sec, steps and epochs."""
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
    steps_per_epoch = n_pad // hp.batch_size

    eval_acc = make_device_eval_fn_global(cfg, hp)
    cfg_eval = eval_budget_cfg(cfg, n_f=hp.eval_n_f, n_var_samples=hp.eval_n_var_samples)
    eval_stacks = {
        split: (stack_eval_set(ds, hp.batch_size, _eval_batches(hp, ds), device=dev), len(ds))
        for split, ds in (("train", train_set), ("val", val_set), ("test", test_set))
    }
    n_eval_batches = max(xs.shape[0] for (xs, _, _), _ in eval_stacks.values())

    def _acc(split, ev):
        (xs, ys, ws), n = eval_stacks[split]
        correct, _ = eval_acc(params, prev, xs, ys, ws, ev, device=dev)
        correct = float(correct)
        if not np.isfinite(correct):
            raise AssertionError("Found NaNs")  # the JAX package's assert, kept under -O
        return correct / n

    stopper = EarlyStopper(patience=hp.patience)
    t_start = time.time()
    steps = 0
    epoch = -1
    last_eval = 0  # epochs completed at the most recent evaluation
    max_block_epochs = max(1, hp.max_steps_per_dispatch // max(steps_per_epoch, 1))
    while epoch + 1 < hp.epochs:
        to_eval = hp.eval_interval - ((epoch + 1) - last_eval)
        block = min(max(to_eval, 1), hp.epochs - (epoch + 1), max_block_epochs)
        params, opt_state, _, pieces = train_block_global(
            params, opt_state, prev, prior, n_train, data_x, data_y, data_w,
            draws.block(n_pad, hp.batch_size, block, cfg, M_prev),
            cfg=cfg, opt=opt, beta=hp.beta, device=dev)
        steps += block * steps_per_epoch
        epoch += block

        if (epoch + 1) - last_eval >= hp.eval_interval or epoch + 1 >= hp.epochs:
            last_eval = epoch + 1
            ev = draws.evaluation(cfg_eval, n_eval_batches, hp.batch_size, True)
            accs = {f"task{task_id}/{split}/acc": _acc(split, ev)
                    for split in ("train", "val", "test")}
            klh, klu, upr, nll = pieces[-1].tolist()
            if not all(np.isfinite(v) for v in (klh, klu, upr, nll)):
                raise FloatingPointError(
                    f"non-finite ELBO at epoch {epoch + 1}: "
                    f"kl_hypers={klh} kl_u={klu} u_prev_reg={upr} nll={nll}"
                )
            if logger is not None:
                for k, v in {
                    f"task{task_id}/loss/kl_hypers": klh,
                    f"task{task_id}/loss/kl_u": klu,
                    f"task{task_id}/loss/u_prev_reg": upr,
                    f"task{task_id}/loss/lik": nll,
                    **accs,
                }.items():
                    logger.add_scalar(k, v, step=epoch + 1)
            # the optimizer returns new tensors and never writes into its
            # inputs: the payload holds the parameters themselves
            stopper(accs[f"task{task_id}/val/acc"],
                    lambda _p=params, _a=accs, _e=epoch: dict(params=_p, acc_summary=_a,
                                                              step=_e + 1))
            if stopper.is_done():
                break

    info = stopper.info() or dict(params=params, acc_summary={}, step=hp.epochs)
    info["steps_per_sec"] = steps / max(time.time() - t_start, 1e-9)
    info["steps"], info["epochs"] = steps, epoch + 1
    return info["params"], info
