"""Task-level training: the ELBO step, the on-device train block, the
evaluation and ``train_task``.

Counterpart of ``vargp_tpu/train/loop.py``.  The ELBO is
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

``train_task`` takes every draw from one draw source (``GeneratorDraws``
by default, over the task's generator): the inducing rows, the initial
parameters' noise, each block's permutations and noise, and each
evaluation's hyper samples and function samples.  A test replays the
JAX package's own draws through the same seam.
"""

import time
from dataclasses import dataclass

import numpy as np
import torch

from vargp_tpu_torch.data.core import ArrayDataset, batch_iter
from vargp_tpu_torch.kernels.deep import DEFAULT_FEATURES, DEFAULT_HIDDEN
from vargp_tpu_torch.likelihoods import softmax_predict
from vargp_tpu_torch.models import vargp as V
from vargp_tpu_torch.ops.device import check_on_device, resolve_device
from vargp_tpu_torch.train.optim import (
    Adam,
    PhiGroup,
    Yogi,
    set_phi_update_scale,
    tree_leaves,
    tree_unflatten,
)
from vargp_tpu_torch.train.stopper import EarlyStopper


@dataclass(frozen=True)
class TrainHyperparams:
    """Every field of the JAX package's ``TrainHyperparams``, with its
    default.  ``scan_epoch=False`` (one host dispatch per minibatch, the
    same math) is not ported: ``train_task`` refuses it."""

    epochs: int = 1
    lr: float = 1e-2
    batch_size: int = 512
    beta: float = 1.0
    eval_interval: int = 10
    patience: int = 20
    optimizer: str = "yogi"  # the reference's torch_optimizer.Yogi
    eval_n_f: int | None = None
    eval_n_var_samples: int | None = None
    scan_epoch: bool = True
    # padded chain: the chain's length (pad_tasks_to), the dataset's rows
    # and the evaluation stacks' batches fixed across the tasks of a run
    pad_tasks_to: int | None = None
    pad_data_rows: int | None = None
    pad_eval_batches: int | None = None
    # the most optimizer steps in one train block; it caps the blocks
    # between evaluations as the JAX package caps its dispatches
    max_steps_per_dispatch: int = 128
    # True: each evaluation batch draws its own hyper samples and posterior
    # (the reference's semantics); False: one posterior per split
    eval_resample_per_batch: bool = False
    # the deep kernel's feature-map (phi) group: its own lr (None: lr),
    # decoupled weight decay, and frozen after the first task
    phi_lr: float | None = None
    phi_weight_decay: float = 0.0
    freeze_phi_after_first: bool = False


def make_optimizer(hp: TrainHyperparams):
    """``Yogi(lr)`` / ``Adam(lr)``, or their ``PhiGroup`` when a phi knob is
    set."""
    if hp.optimizer == "yogi":
        inner = Yogi(hp.lr)
    elif hp.optimizer == "adam":
        inner = Adam(hp.lr)
    else:
        raise ValueError(f"unknown optimizer {hp.optimizer!r}")
    if hp.phi_lr is None and not hp.phi_weight_decay and not hp.freeze_phi_after_first:
        return inner
    return PhiGroup(inner, phi_lr=hp.phi_lr, phi_weight_decay=hp.phi_weight_decay,
                    freeze=hp.freeze_phi_after_first)


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
                data_w, gen: torch.Generator | None, *, cfg: V.VARGPConfig, opt, beta: float,
                batch_size: int, n_epochs: int, device=None, draws=None):
    """``n_epochs`` epochs of ELBO steps over a dataset padded to a
    multiple of ``batch_size`` with zero-weight rows (``pad_dataset_to_device``).
    The steps' (row indices, noise) are ``draws`` when given, else
    ``block_draws`` from ``gen``.  Returns (params, opt_state, losses
    (steps,), pieces (steps, 3)), all on the device."""
    dev = resolve_device(device)
    n_pad = data_x.shape[0]
    if n_pad % batch_size:
        raise ValueError(f"{n_pad} dataset rows are not a multiple of {batch_size}")
    if draws is None:
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, the block runs on {dev}")
        draws = block_draws(gen, n_pad, batch_size, n_epochs, cfg, len(prev))
    losses, pieces = [], []
    for idx, noise in draws:
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


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

_MULTI_DEVICE = ("multi-device runs (a mesh, --n_devices, --model_parallel, several "
                 "processes) are not ported yet: ROADMAP Queue A item 6")


def _eval_budgets(hp: TrainHyperparams | None):
    if hp is None:
        return None, None, False
    return hp.eval_n_f, hp.eval_n_var_samples, hp.eval_resample_per_batch


def eval_predictions(params, prev, chain_mask, xs, draws: dict, cfg: V.VARGPConfig,
                     hp: TrainHyperparams | None = None, *, device=None):
    """Yield each stacked batch's class probabilities (B, out_size).

    ``draws`` is one evaluation's noise (``GeneratorDraws.evaluation``):
    ``hyper_eps`` (n_v, P+1), or (K, n_v, P+1) under
    ``hp.eval_resample_per_batch``, and ``lik_eps`` (K, H, n_f, O, B),
    batch i taking ``lik_eps[i]``.  By default theta is drawn once and the
    posterior built once for all the batches (``build_posterior``, then
    ``marginal_diag`` and ``softmax_predict`` per batch): the same MC
    estimator over the split as the reference's per-batch ``predict``,
    which ``eval_resample_per_batch`` restores."""
    dev = resolve_device(device)
    n_f, n_v, resample = _eval_budgets(hp)
    if resample:
        for i in range(xs.shape[0]):
            noise = {"hyper_eps": draws["hyper_eps"][i], "lik_eps": draws["lik_eps"][i]}
            yield V.predict(params, prev, xs[i], noise, cfg, n_f=n_f, n_var_samples=n_v,
                            chain_mask=chain_mask, device=dev)
        return
    check_on_device(dev, *V._tensors(params, prev, xs, chain_mask, *draws.values()))
    cp = V.build_posterior(params, prev, draws["hyper_eps"], cfg, chain_mask=chain_mask)
    for i in range(xs.shape[0]):
        f_mean, f_var = V.marginal_diag(cp, params, xs[i], cfg, chain_mask=chain_mask)
        yield softmax_predict(f_mean, f_var, draws["lik_eps"][i])


def make_device_eval_fn(cfg: V.VARGPConfig, hp: TrainHyperparams | None = None, mesh=None):
    """Whole-split accuracy: ``eval_acc(params, prev, chain_mask, xs, ys,
    ws, draws, device=None)`` over stacked batches xs (K, B, D), ys / ws
    (K, B) returns (correct count, weight count), tensors on the device.

    The count and an "every probability finite" flag accumulate on the
    device, so a split costs the caller one host read.  A non-finite
    probability anywhere makes the count NaN: the argmax of NaN
    probabilities is still an index, so a count alone would hide a
    diverged posterior (the reference asserts on the probabilities)."""
    if mesh is not None:
        raise NotImplementedError(_MULTI_DEVICE)

    def eval_acc(params, prev, chain_mask, xs, ys, ws, draws, *, device=None):
        with torch.no_grad():
            correct = xs.new_zeros(())
            ok = torch.ones((), dtype=torch.bool, device=xs.device)
            for i, probs in enumerate(eval_predictions(params, prev, chain_mask, xs, draws, cfg,
                                                       hp, device=device)):
                hits = (torch.argmax(probs, dim=-1) == ys[i]).to(torch.float32) * ws[i]
                ok = ok & torch.all(torch.isfinite(probs))
                correct = correct + torch.sum(hits)
            correct = torch.where(ok, correct, torch.full_like(correct, float("nan")))
            return correct, torch.sum(ws)

    return eval_acc


def stack_eval_set(ds: ArrayDataset, batch_size: int, n_batches: int | None = None, *,
                   device=None):
    """(xs (K, B, D), ys (K, B), ws (K, B)) on ``device``: the dataset in
    fixed-shape evaluation batches, the last one padded with zero-weight
    rows, then zero-weight batches up to ``n_batches`` when given."""
    xs, ys, ws = [], [], []
    for b in batch_iter(ds, batch_size, shuffle=False):
        xs.append(b.x)
        ys.append(b.y)
        ws.append(b.w)
    if n_batches is not None:
        while len(xs) < n_batches:
            xs.append(np.zeros_like(xs[0]))
            ys.append(np.zeros_like(ys[0]))
            ws.append(np.zeros_like(ws[0]))
    dev = resolve_device(device)
    return tuple(torch.from_numpy(np.stack(a)).to(dev) for a in (xs, ys, ws))


def make_predict_fn(cfg: V.VARGPConfig, hp: TrainHyperparams | None = None):
    """``predict(params, prev, x, noise, device=None)`` at the evaluation
    budgets of ``hp``."""
    n_f, n_v, _ = _eval_budgets(hp)

    def predict(params, prev, x, noise, *, device=None):
        with torch.no_grad():
            return V.predict(params, prev, x, noise, cfg, n_f=n_f, n_var_samples=n_v,
                             device=device)

    return predict


def _eval_batches(hp: TrainHyperparams, ds: ArrayDataset) -> int | None:
    if hp.pad_eval_batches is None:
        return None
    need = -(-len(ds) // hp.batch_size)
    return max(hp.pad_eval_batches, need)


# ---------------------------------------------------------------------------
# train_task
# ---------------------------------------------------------------------------


class GeneratorDraws:
    """``train_task``'s draws from one ``torch.Generator``, on its device.

    A draw source has four methods, called in the order ``train_task``
    needs them: ``inducing`` (the inducing inputs), ``init`` (the initial
    parameters' noise), ``block`` (a train block's row indices and noise,
    step by step) and ``evaluation`` (one evaluation's noise, shared by
    its train, validation and test splits, as the JAX package shares one
    key)."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def _normal(self, *shape):
        return torch.randn(shape, generator=self.gen, device=self.gen.device)

    def inducing(self, data: torch.Tensor, M: int, out_size: int) -> torch.Tensor:
        return V.select_inducing(self.gen, data, M, out_size)

    def init(self, cfg: V.VARGPConfig, with_phi: bool) -> dict:
        """kernel_eps (P+1,), u_eps (O, M, 1) and, when ``with_phi``, the
        MLP's U[0, 1) draws (``kernels.deep.init_mlp``)."""
        out = {"kernel_eps": self._normal(V._theta_size(cfg) + 1),
               "u_eps": self._normal(cfg.out_size, cfg.M, 1)}
        if with_phi:
            dims = [cfg.in_size, DEFAULT_HIDDEN, DEFAULT_HIDDEN, DEFAULT_FEATURES]
            out["phi_uniform"] = [
                torch.rand(shape, generator=self.gen, device=self.gen.device)
                for a, b in zip(dims, dims[1:]) for shape in ((a, b), (b,))
            ]
        return out

    def block(self, n_pad: int, batch_size: int, n_epochs: int, cfg: V.VARGPConfig,
              n_prev: int):
        return block_draws(self.gen, n_pad, batch_size, n_epochs, cfg, n_prev)

    def evaluation(self, cfg_eval: V.VARGPConfig, n_batches: int, batch_size: int,
                   per_batch: bool) -> dict:
        """hyper_eps (n_v, P+1), or (K, n_v, P+1) when ``per_batch``, then
        lik_eps (K, H, n_f, O, B), K = ``n_batches``."""
        H = 1 if cfg_eval.map_est_hypers else cfg_eval.n_var_samples
        hyper = (cfg_eval.n_var_samples, V._theta_size(cfg_eval) + 1)
        return {
            "hyper_eps": self._normal(*((n_batches,) if per_batch else ()), *hyper),
            "lik_eps": self._normal(n_batches, H, cfg_eval.n_f, cfg_eval.out_size, batch_size),
        }


def train_task(gen, task_id: int, train_set: ArrayDataset, val_set: ArrayDataset,
               test_set: ArrayDataset, cfg: V.VARGPConfig, hp: TrainHyperparams,
               prev_chain=(), logger=None, seed: int | None = None, ls_init=None,
               shared: dict | None = None, mesh=None, *, device=None, draws=None):
    """Train one task; returns (best_params, info).

    ``gen`` is the task's ``torch.Generator`` on ``device`` (None means the
    card), or an int seed for one.  ``draws`` replaces the draw source
    (``GeneratorDraws(gen)``).  ``prev_chain`` holds the best parameters
    of every earlier task: the frozen chain, the kernel prior and, under
    DKL, phi's warm start come from it.  The run trains in blocks of
    epochs (``train_block``) that end on the evaluation cadence, each at
    most ``hp.max_steps_per_dispatch`` steps' worth of whole epochs; at
    each evaluation it logs the ELBO pieces and the three splits'
    accuracies and feeds the validation accuracy to an ``EarlyStopper``.
    ``shared`` carries the optimizer and the evaluation function across a
    run's tasks.  ``seed`` is the JAX signature's data seed, read only by
    the per-minibatch mode, which is not ported.  ``info`` holds the best
    evaluation's params, acc_summary and step (its epoch), and the run's
    steps_per_sec, steps and epochs."""
    if not hp.scan_epoch:
        raise NotImplementedError(
            "scan_epoch=False (one host dispatch per minibatch) is not ported: "
            "train blocks are the port's only mode")
    if mesh is not None:
        raise NotImplementedError(_MULTI_DEVICE)
    dev = resolve_device(device)
    if draws is None:
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(gen))
        draws = GeneratorDraws(gen)

    prev = tuple(V.freeze_task(p) for p in prev_chain)
    if hp.pad_tasks_to is not None:
        prev, chain_mask = V.pad_chain(prev, cfg, hp.pad_tasks_to, device=dev)
    else:
        chain_mask = torch.ones((len(prev),), device=dev)
    shared = shared if shared is not None else {}
    kernel_prior_from = prev_chain[-1].kernel if prev_chain else None
    phi_init = prev_chain[-1].phi if (prev_chain and cfg.dkl) else None

    x_train = torch.from_numpy(np.ascontiguousarray(train_set.data)).to(dev)
    z_init = draws.inducing(x_train, cfg.M, cfg.out_size)
    log_ls = None
    if ls_init == "median":
        log_ls = V.median_log_lengthscale(x_train)
    elif ls_init is not None:
        log_ls = float(np.log(ls_init))
    init = draws.init(cfg, with_phi=cfg.dkl and phi_init is None)
    params, prior = V.init_params(
        init["kernel_eps"], init["u_eps"], z_init, cfg, kernel_prior_from=kernel_prior_from,
        phi_uniform=init.get("phi_uniform"), phi_init=phi_init, log_lengthscale_init=log_ls,
    )

    opt = shared.setdefault("opt", make_optimizer(hp))
    opt_state = opt.init(params)
    if hp.freeze_phi_after_first and cfg.dkl and task_id > 0:
        opt_state = set_phi_update_scale(opt_state, 0.0)
    n_train = torch.tensor(float(len(train_set)), device=dev)
    data_x, data_y, data_w = pad_dataset_to_device(
        train_set.data, train_set.targets, hp.batch_size, n_rows=hp.pad_data_rows, device=dev)
    n_pad = data_x.shape[0]
    steps_per_epoch = n_pad // hp.batch_size

    eval_acc = shared.setdefault("eval_acc", make_device_eval_fn(cfg, hp))
    cfg_eval = V.eval_budget_cfg(cfg, n_f=hp.eval_n_f, n_var_samples=hp.eval_n_var_samples)
    eval_stacks = {
        split: (stack_eval_set(ds, hp.batch_size, _eval_batches(hp, ds), device=dev), len(ds))
        for split, ds in (("train", train_set), ("val", val_set), ("test", test_set))
    }
    n_eval_batches = max(xs.shape[0] for (xs, _, _), _ in eval_stacks.values())

    def _acc(split, ev):
        (xs, ys, ws), n = eval_stacks[split]
        correct, _ = eval_acc(params, prev, chain_mask, xs, ys, ws, ev, device=dev)
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
        # a block ends on the evaluation cadence even when
        # max_steps_per_dispatch caps it below eval_interval
        to_eval = hp.eval_interval - ((epoch + 1) - last_eval)
        block = min(max(to_eval, 1), hp.epochs - (epoch + 1), max_block_epochs)
        params, opt_state, _, pieces = train_block(
            params, opt_state, prev, prior, chain_mask, n_train, data_x, data_y, data_w, None,
            cfg=cfg, opt=opt, beta=hp.beta, batch_size=hp.batch_size, n_epochs=block,
            device=dev, draws=draws.block(n_pad, hp.batch_size, block, cfg, len(prev)),
        )
        steps += block * steps_per_epoch
        epoch += block

        if (epoch + 1) - last_eval >= hp.eval_interval or epoch + 1 >= hp.epochs:
            last_eval = epoch + 1
            ev = draws.evaluation(cfg_eval, n_eval_batches, hp.batch_size,
                                  hp.eval_resample_per_batch)
            train_acc = _acc("train", ev)
            val_acc = _acc("val", ev)
            test_acc = _acc("test", ev)

            klh, klu, nll = pieces[-1].tolist()
            if not all(np.isfinite(v) for v in (klh, klu, nll)):
                raise FloatingPointError(
                    f"non-finite ELBO at epoch {epoch + 1}: "
                    f"kl_hypers={klh} kl_u={klu} nll={nll}"
                )
            scalars = {
                f"task{task_id}/loss/kl_hypers": klh,
                f"task{task_id}/loss/kl_u": klu,
                f"task{task_id}/loss/lik": nll,
                f"task{task_id}/train/acc": train_acc,
                f"task{task_id}/val/acc": val_acc,
                f"task{task_id}/test/acc": test_acc,
            }
            if logger is not None:
                for k, v in scalars.items():
                    logger.add_scalar(k, v, step=epoch + 1)

            # The payload holds the parameters themselves: the optimizer's
            # update returns new tensors and never writes into its inputs,
            # so no later step changes them (the JAX package copies them
            # because its update donates its input buffers).
            stopper(
                val_acc,
                lambda _p=params, _e=epoch, _t=train_acc, _v=val_acc, _s=test_acc: dict(
                    params=_p,
                    acc_summary={
                        f"task{task_id}/train/acc": _t,
                        f"task{task_id}/val/acc": _v,
                        f"task{task_id}/test/acc": _s,
                    },
                    step=_e + 1,
                ),
            )
            if stopper.is_done():
                break

    info = stopper.info() or dict(params=params, acc_summary={}, step=hp.epochs)
    info["steps_per_sec"] = steps / max(time.time() - t_start, 1e-9)
    info["steps"], info["epochs"] = steps, epoch + 1
    if logger is not None:
        for k, v in info.get("acc_summary", {}).items():
            logger.add_scalar(f"{k}_best", v, step=info.get("step", 0))
    return info["params"], info
