"""Task-level training: the ELBO step, the on-device train block, the
evaluation and ``train_task``.

Counterpart of ``vargp_tpu/train/loop.py``.  The ELBO is
beta * kl_hypers + kl_u + (n_train / sum(w)) * nll (experiments/vargp.py
of the reference); its gradient comes from ``models.vargp.loss``'s
backward and the update from ``train.optim``.

Every model the port trains takes its step (``gradient_step``), train
block (``step_block``), draws' order (``block_draws``), blocks' schedule
(``epoch_blocks``) and accuracy count (``count_correct``) from here;
VAR-GP and the global SVGP also share the task loop (``fit``).

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

Under a ("data", "model") mesh (``vargp_tpu_torch.parallel``) the same
functions run on each rank's shards: its classes' parameters and chain,
its rows of each batch.  Every rank draws the whole step's noise and the
whole epoch's permutation from an identically seeded generator and keeps
its slice, so a sharded run is the single-device estimator.  The mesh
adds the collectives and nothing else: the gather of the function
samples' moments over "model" before the softmax, the sums of the batch
weight, kl_u and the nll, and the gradients' sums.
"""

import time
from dataclasses import dataclass

import numpy as np
import torch

from vargp_tpu_torch.data.core import ArrayDataset, batch_iter
from vargp_tpu_torch.kernels.deep import DEFAULT_FEATURES, DEFAULT_HIDDEN
from vargp_tpu_torch.likelihoods import softmax_loss, softmax_predict
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
from vargp_tpu_torch.utils import tracing


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


def _shard_noise(noise: dict, mesh, out_size: int):
    """(the forward's noise on this rank's classes and rows, the function
    samples' noise on its rows for every class, the whole batch's rows)
    of a step's whole noise: hyper_eps whole, prefix_eps sliced on the
    classes, lik_eps on the classes and the rows."""
    lik = noise["lik_eps"]
    B = lik.shape[-1]
    cs, rs = mesh.class_slice(out_size), mesh.row_slice(B)
    local = {"hyper_eps": noise["hyper_eps"], "lik_eps": lik[:, :, cs, rs]}
    if "prefix_eps" in noise:
        local["prefix_eps"] = noise["prefix_eps"][:, :, cs]
    return local, lik[..., rs], B


def _class_moments(mesh, f_mean, f_var):
    """(f_mean, f_var) of every class, (H, O, B / dp): this rank's classes
    gathered with the others' over the model axis, in one collective."""
    if mesh.shape[1] == 1:
        return f_mean, f_var
    both = mesh.gather_classes(torch.stack([f_mean, f_var]), dim=2)
    return both[0], both[1]


def _sharded_loss(params, prev, prior, x, y, w, noise, cfg, chain_mask, dev, mesh):
    """This rank's ELBO pieces: kl_hypers, kl_u over its classes, the nll
    over its rows (every class's moments gathered before the softmax)."""
    check_on_device(dev, *V._tensors(params, prev, *prior, x, y, w, chain_mask,
                                     *noise.values()))
    local, lik_rows, B = _shard_noise(noise, mesh, cfg.out_size)
    if x.shape[0] * mesh.shape[0] != B:
        raise ValueError(f"{x.shape[0]} rows on a rank of {mesh.shape[0]} data ranks, the "
                         f"noise's batch has {B}")
    out = V.forward(params, prev, prior, x, local, mesh.local_cfg(cfg), with_kl=True,
                    chain_mask=chain_mask)
    f_mean, f_var = _class_moments(mesh, out.f_mean, out.f_var)
    nll = softmax_loss(f_mean, f_var, y, lik_rows, weights=w)
    return out.kl_hypers, out.kl_u, nll


def gradient_step(params, opt_state, objective, opt, reduce=None):
    """One optimizer step of any model on ``objective(params) -> (loss,
    pieces)``: the gradient over the parameters' leaves (0 for a leaf the
    loss does not read, log_logvar under MAP), then ``opt.update``.
    ``reduce(grads, pieces) -> (grads, loss, pieces)`` runs between the
    two: the sharded step sums there.  Returns (params, opt_state,
    loss, pieces), the loss and pieces taken before the update, detached."""
    with tracing.span("elbo_step"):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        with torch.enable_grad():
            loss, pieces = objective(tree_unflatten(params, leaves))
        with tracing.span("backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
        loss, pieces = loss.detach(), tuple(p.detach() for p in pieces)
        if reduce is not None:
            grads, loss, pieces = reduce(grads, pieces)
        with tracing.span("update"):
            params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss, pieces


def elbo_step(params, opt_state, prev, prior, x, y, w, noise, *,
              cfg: V.VARGPConfig, opt, beta: float, n_train, chain_mask=None,
              device=None, mesh=None):
    """One optimizer step on the ELBO.  Returns (params, opt_state, loss,
    (kl_hypers, kl_u, nll)), the loss and its pieces taken before the
    update and detached.  ``device=None`` means the card.

    Under ``mesh`` the parameters, chain and optimizer state are this
    rank's shards, x, y, w its rows, and ``noise`` the whole step's; the
    returned loss and pieces are the whole job's, the same on every rank.
    The ELBO is split into rank shares whose sum is the ELBO (kl_hypers
    over every rank, each class's kl_u over the data ranks, each row's nll
    over the model ranks), each rank differentiates its share, and the
    gradients are summed where their leaves are shared."""
    w_sum = torch.sum(w) if mesh is None else mesh.all_sum(torch.sum(w), "data", "sum w")
    scale = n_train / torch.clamp(w_sum, min=1.0)
    if mesh is None:
        def objective(p):
            klh, klu, nll = V.loss(p, prev, prior, x, y, noise, cfg, weights=w,
                                   chain_mask=chain_mask, device=device)
            return beta * klh + klu + scale * nll, (klh, klu, nll)

        return gradient_step(params, opt_state, objective, opt)

    dp, mp = mesh.shape

    def share(p):
        klh, klu, nll = _sharded_loss(p, prev, prior, x, y, w, noise, cfg, chain_mask,
                                      resolve_device(device), mesh)
        return beta * klh / (dp * mp) + klu / dp + scale * nll / mp, (klh, klu, nll)

    def job(grads, pieces):
        klh, klu, nll = pieces
        grads = mesh.sum_gradients(grads, params, cfg.out_size)
        klu = mesh.all_sum(klu, "model", "sum kl_u")
        nll = mesh.all_sum(nll, "data", "sum nll")
        return grads, beta * klh + klu + scale * nll, (klh, klu, nll)

    return gradient_step(params, opt_state, share, opt, job)


def block_draws(gen: torch.Generator, n_pad: int, batch_size: int, n_epochs: int, noise):
    """Yield (batch row indices, noise) for every step of a train block, in
    the order the block draws them from ``gen``: per epoch one permutation
    of the ``n_pad`` rows, then ``noise()`` for each of its steps."""
    for _ in range(n_epochs):
        perm = torch.randperm(n_pad, generator=gen, device=gen.device)
        for s in range(n_pad // batch_size):
            yield perm[s * batch_size:(s + 1) * batch_size], noise()


def step_block(step, params, opt_state, draws, data_x, data_y, data_w, rows=slice(None)):
    """Every model's train block: one ``step(params, opt_state, x, y, w,
    noise)`` per (row indices, noise) of ``draws`` on the dataset's rows
    ``idx[rows]``, with no host read between steps.  Returns (params,
    opt_state, losses (steps,), pieces (steps, k)), on the device."""
    losses, pieces = [], []
    with tracing.span("train_block"):
        for idx, noise in draws:
            idx = idx[rows]
            params, opt_state, loss, aux = step(params, opt_state, data_x[idx], data_y[idx],
                                                data_w[idx], noise)
            losses.append(loss)
            pieces.append(torch.stack(aux))
    return params, opt_state, torch.stack(losses), torch.stack(pieces)


def train_block(params, opt_state, prev, prior, chain_mask, n_train, data_x, data_y,
                data_w, gen: torch.Generator | None, *, cfg: V.VARGPConfig, opt, beta: float,
                batch_size: int, n_epochs: int, device=None, draws=None, mesh=None):
    """``n_epochs`` epochs of ELBO steps over a dataset padded to a
    multiple of ``batch_size`` with zero-weight rows (``pad_dataset_to_device``).
    The steps' (row indices, noise) are ``draws`` when given, else
    ``GeneratorDraws(gen).block``'s.  Returns (params, opt_state, losses
    (steps,), pieces (steps, 3)), all on the device.  Under ``mesh`` every
    rank holds the dataset whole and steps on its rows of each batch."""
    dev = resolve_device(device)
    n_pad = data_x.shape[0]
    if n_pad % batch_size:
        raise ValueError(f"{n_pad} dataset rows are not a multiple of {batch_size}")
    if draws is None:
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, the block runs on {dev}")
        draws = GeneratorDraws(gen).block(n_pad, batch_size, n_epochs, cfg, len(prev))

    def step(params, opt_state, x, y, w, noise):
        # looked up at each step: a caller may replace the module's elbo_step
        return elbo_step(params, opt_state, prev, prior, x, y, w, noise, cfg=cfg, opt=opt,
                         beta=beta, n_train=n_train, chain_mask=chain_mask, device=dev,
                         mesh=mesh)

    rows = slice(None) if mesh is None else mesh.row_slice(batch_size)
    return step_block(step, params, opt_state, draws, data_x, data_y, data_w, rows)


def epoch_blocks(hp: TrainHyperparams, steps_per_epoch: int):
    """Yield (epochs of a train block, epochs done after it): blocks that
    end on every multiple of ``hp.eval_interval`` and at ``hp.epochs``, each
    at most ``hp.max_steps_per_dispatch`` steps' worth of whole epochs (at
    least one), as the JAX package caps its dispatches."""
    cadence = max(hp.eval_interval, 1)
    cap = max(1, hp.max_steps_per_dispatch // max(steps_per_epoch, 1))
    done = 0
    while done < hp.epochs:
        n = min(cadence - done % cadence, hp.epochs - done, cap)
        done += n
        yield n, done


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

def _eval_budgets(hp: TrainHyperparams | None):
    if hp is None:
        return None, None, False
    return hp.eval_n_f, hp.eval_n_var_samples, hp.eval_resample_per_batch


def predict_probs(params, prev, x, noise: dict, cfg: V.VARGPConfig, *, n_f: int | None = None,
                  n_var_samples: int | None = None, chain_mask=None, device=None, mesh=None):
    """Class probabilities (B, out_size): ``V.predict``; under ``mesh``
    those of this rank's rows ``x`` (B / dp of them) from its shards and
    the whole batch's ``noise``."""
    if mesh is None:
        return V.predict(params, prev, x, noise, cfg, n_f=n_f, n_var_samples=n_var_samples,
                         chain_mask=chain_mask, device=device)
    check_on_device(resolve_device(device), *V._tensors(params, prev, x, chain_mask,
                                                        *noise.values()))
    cfg_eval = V.eval_budget_cfg(cfg, n_f=n_f, n_var_samples=n_var_samples)
    local, lik_rows, _ = _shard_noise(noise, mesh, cfg.out_size)
    out = V.forward(params, prev, None, x, local, mesh.local_cfg(cfg_eval), with_kl=False,
                    chain_mask=chain_mask)
    return softmax_predict(*_class_moments(mesh, out.f_mean, out.f_var), lik_rows)


def eval_predictions(params, prev, chain_mask, xs, draws: dict, cfg: V.VARGPConfig,
                     hp: TrainHyperparams | None = None, *, device=None, mesh=None):
    """Yield each stacked batch's class probabilities (B, out_size).

    ``draws`` is one evaluation's noise (``GeneratorDraws.evaluation``):
    ``hyper_eps`` (n_v, P+1), or (K, n_v, P+1) under
    ``hp.eval_resample_per_batch``, and ``lik_eps`` (K, H, n_f, O, B),
    batch i taking ``lik_eps[i]``.  By default theta is drawn once and the
    posterior built once for all the batches (``build_posterior``, then
    ``marginal_diag`` and ``softmax_predict`` per batch): the same MC
    estimator over the split as the reference's per-batch ``predict``,
    which ``eval_resample_per_batch`` restores.  Under ``mesh``, xs holds
    this rank's rows of each batch and the draws are the whole split's."""
    dev = resolve_device(device)
    n_f, n_v, resample = _eval_budgets(hp)
    if resample:
        for i in range(xs.shape[0]):
            noise = {"hyper_eps": draws["hyper_eps"][i], "lik_eps": draws["lik_eps"][i]}
            yield predict_probs(params, prev, xs[i], noise, cfg, n_f=n_f, n_var_samples=n_v,
                                chain_mask=chain_mask, device=dev, mesh=mesh)
        return
    check_on_device(dev, *V._tensors(params, prev, xs, chain_mask, *draws.values()))
    lcfg = cfg if mesh is None else mesh.local_cfg(cfg)
    cp = V.build_posterior(params, prev, draws["hyper_eps"], lcfg, chain_mask=chain_mask)
    for i in range(xs.shape[0]):
        f_mean, f_var = V.marginal_diag(cp, params, xs[i], lcfg, chain_mask=chain_mask)
        lik = draws["lik_eps"][i]
        if mesh is not None:
            f_mean, f_var = _class_moments(mesh, f_mean, f_var)
            lik = lik[..., mesh.row_slice(lik.shape[-1])]
        yield softmax_predict(f_mean, f_var, lik)


def count_correct(probs, ys, ws) -> torch.Tensor:
    """The weighted count of rows whose most probable class is the label
    over the class probabilities ``probs`` yields (batch i against ys[i],
    ws[i]), on the device.  Any non-finite probability makes it NaN: the
    argmax of NaN probabilities is still an index, so a count alone would
    hide a diverged posterior (the reference asserts on the probabilities)."""
    correct = ws.new_zeros(())
    ok = torch.ones((), dtype=torch.bool, device=ws.device)
    for i, p in enumerate(probs):
        hits = (torch.argmax(p, dim=-1) == ys[i]).to(torch.float32) * ws[i]
        ok = ok & torch.all(torch.isfinite(p))
        correct = correct + torch.sum(hits)
    return torch.where(ok, correct, torch.full_like(correct, float("nan")))


def make_device_eval_fn(cfg: V.VARGPConfig, hp: TrainHyperparams | None = None, mesh=None):
    """Whole-split accuracy: ``eval_acc(params, prev, chain_mask, xs, ys,
    ws, draws, device=None)`` over stacked batches xs (K, B, D), ys / ws
    (K, B) returns (correct count, weight count), tensors on the device.

    The count accumulates on the device (``count_correct``: NaN after a
    non-finite probability), so a split costs the caller one host read.
    Under ``mesh`` the stacks hold this rank's rows of each batch, and the
    counts are summed over the data axis (a NaN reaches every rank)."""

    def eval_acc(params, prev, chain_mask, xs, ys, ws, draws, *, device=None):
        with torch.no_grad():
            correct = count_correct(eval_predictions(params, prev, chain_mask, xs, draws, cfg,
                                                     hp, device=device, mesh=mesh), ys, ws)
            if mesh is None:
                return correct, torch.sum(ws)
            counts = mesh.all_sum(torch.stack([correct, torch.sum(ws)]), "data", "sum counts")
            return counts[0], counts[1]

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


SPLITS = ("train", "val", "test")


def stack_splits(hp: TrainHyperparams, splits, *, device, rows=slice(None)):
    """({split: (``stack_eval_set``'s stacks cut to ``rows``, the split's
    length)}, the most batches of a split) of the train, val and test sets."""
    stacks = {
        split: (tuple(a[:, rows] for a in stack_eval_set(
            ds, hp.batch_size, _eval_batches(hp, ds), device=device)), len(ds))
        for split, ds in zip(SPLITS, splits)
    }
    return stacks, max(xs.shape[0] for (xs, _, _), _ in stacks.values())


def split_accuracies(count, stacks, task_id: int) -> dict:
    """{``task{t}/{split}/acc``: accuracy} of the stacks, one host read a
    split of ``count(xs, ys, ws)``, its correct count; NaN raises."""
    accs = {}
    for split in SPLITS:
        (xs, ys, ws), n = stacks[split]
        correct = float(count(xs, ys, ws))
        if not np.isfinite(correct):
            raise AssertionError("Found NaNs")  # the JAX package's assert, kept under -O
        accs[f"task{task_id}/{split}/acc"] = correct / n
    return accs


def finite_pieces(pieces, names, epoch: int) -> list:
    """The last step's ELBO pieces read back; any non-finite one raises."""
    values = pieces[-1].tolist()
    if not all(np.isfinite(v) for v in values):
        raise FloatingPointError(f"non-finite ELBO at epoch {epoch}: " + " ".join(
            f"{n}={v}" for n, v in zip(names, values)))
    return values


def fit(params, opt_state, block, evaluate, hp: TrainHyperparams, task_id: int,
        steps_per_epoch: int, names, logger=None) -> dict:
    """The VAR-GP and global ``train_task``'s loop: ``block(params,
    opt_state, n_epochs)`` (``step_block``'s outputs) on ``epoch_blocks``,
    ``evaluate(params)`` (``split_accuracies``) on the cadence and at the
    last epoch, where the finite ELBO pieces (``names``) and accuracies are
    logged and the validation accuracy goes to an ``EarlyStopper``.
    Returns ``info``: the best evaluation's params, acc_summary and step
    (its epoch), and the run's steps_per_sec, steps and epochs."""
    stopper = EarlyStopper(patience=hp.patience)
    t_start = time.time()
    steps = done = 0
    for n_epochs, done in epoch_blocks(hp, steps_per_epoch):
        params, opt_state, _, pieces = block(params, opt_state, n_epochs)
        steps += n_epochs * steps_per_epoch
        if done < hp.epochs and done % max(hp.eval_interval, 1):
            continue
        accs = evaluate(params)
        values = finite_pieces(pieces, names, done)
        if logger is not None:
            for k, v in zip(names, values):
                logger.add_scalar(f"task{task_id}/loss/{k}", v, step=done)
            for k, v in accs.items():
                logger.add_scalar(k, v, step=done)
        # The payload holds the parameters themselves: the optimizer's
        # update returns new tensors and never writes into its inputs, so
        # no later step changes them (the JAX package copies them because
        # its update donates its input buffers).
        stopper(accs[f"task{task_id}/val/acc"],
                lambda _p=params, _a=accs, _e=done: dict(params=_p, acc_summary=_a, step=_e))
        if stopper.is_done():
            break
    info = stopper.info() or dict(params=params, acc_summary={}, step=hp.epochs)
    info["steps_per_sec"] = steps / max(time.time() - t_start, 1e-9)
    info["steps"], info["epochs"] = steps, done
    return info


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
    key).  A model's source differs in its ``draw_noise``."""

    draw_noise = staticmethod(draw_noise)

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

    def block(self, n_pad: int, batch_size: int, n_epochs: int, cfg, *shape):
        """``block_draws``, each step's noise ``draw_noise(gen, cfg, *shape,
        batch_size)``: for VAR-GP ``shape`` is the chain's length."""
        return block_draws(self.gen, n_pad, batch_size, n_epochs,
                           lambda: self.draw_noise(self.gen, cfg, *shape, batch_size))

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
    DKL, phi's warm start come from it.  The task runs ``train_block``
    and the evaluation through ``fit``, whose ``info`` it returns.
    ``shared`` carries the optimizer and the evaluation function across a
    run's tasks.  ``seed`` is the JAX signature's data seed, read only by
    the per-minibatch mode, which is not ported.

    ``mesh`` (``parallel.make_mesh``) runs the task sharded: ``gen`` is
    the task's generator seeded alike on every rank (or its seed), and
    ``prev_chain`` holds whole parameters on every rank.  The parameters,
    their moments and the frozen padded chain are sharded over "model",
    the prior and the chain mask replicated, each minibatch and
    evaluation batch split over "data".  The device is the mesh's, and
    ``best_params`` (and ``info["params"]``) are this rank's shard
    (``parallel.unshard_to_host`` gathers them)."""
    if not hp.scan_epoch:
        raise NotImplementedError(
            "scan_epoch=False (one host dispatch per minibatch) is not ported: "
            "train blocks are the port's only mode")
    if mesh is None:
        dev = resolve_device(device)
        shard = replicate = lambda tree: tree
    else:
        from vargp_tpu_torch import parallel  # parallel imports this module

        dev = mesh.device
        if device is not None and resolve_device(device).type != dev.type:
            raise ValueError(f"device={device!r}, the mesh's rank runs on {dev}")

        def shard(tree):
            return parallel.shard_params(tree, mesh, cfg.out_size)

        def replicate(tree):
            return parallel.replicate(tree, mesh)

    if draws is None:
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(gen))
        draws = GeneratorDraws(gen)

    prev = tuple(V.freeze_task(p) for p in prev_chain)
    if hp.pad_tasks_to is not None:
        prev, chain_mask = V.pad_chain(prev, cfg, hp.pad_tasks_to, device=dev)
    else:
        chain_mask = torch.ones((len(prev),), device=dev)
    prev, chain_mask = shard(prev), replicate(chain_mask)
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
    params, prior = shard(params), replicate(prior)

    opt = shared.setdefault("opt", make_optimizer(hp))
    opt_state = opt.init(params)
    if hp.freeze_phi_after_first and cfg.dkl and task_id > 0:
        opt_state = set_phi_update_scale(opt_state, 0.0)
    n_train = torch.tensor(float(len(train_set)), device=dev)
    data_x, data_y, data_w = pad_dataset_to_device(
        train_set.data, train_set.targets, hp.batch_size, n_rows=hp.pad_data_rows, device=dev)
    n_pad = data_x.shape[0]

    eval_acc = shared.setdefault("eval_acc", make_device_eval_fn(cfg, hp, mesh))
    cfg_eval = V.eval_budget_cfg(cfg, n_f=hp.eval_n_f, n_var_samples=hp.eval_n_var_samples)
    rows = slice(None) if mesh is None else mesh.row_slice(hp.batch_size)
    stacks, n_eval_batches = stack_splits(hp, (train_set, val_set, test_set), device=dev,
                                          rows=rows)

    def block(params, opt_state, n_epochs):
        return train_block(
            params, opt_state, prev, prior, chain_mask, n_train, data_x, data_y, data_w, None,
            cfg=cfg, opt=opt, beta=hp.beta, batch_size=hp.batch_size, n_epochs=n_epochs,
            device=dev, draws=draws.block(n_pad, hp.batch_size, n_epochs, cfg, len(prev)),
            mesh=mesh)

    def evaluate(params):
        ev = draws.evaluation(cfg_eval, n_eval_batches, hp.batch_size,
                              hp.eval_resample_per_batch)
        return split_accuracies(
            lambda xs, ys, ws: eval_acc(params, prev, chain_mask, xs, ys, ws, ev, device=dev)[0],
            stacks, task_id)

    info = fit(params, opt_state, block, evaluate, hp, task_id, n_pad // hp.batch_size,
               ("kl_hypers", "kl_u", "lik"), logger)
    if logger is not None:
        for k, v in info.get("acc_summary", {}).items():
            logger.add_scalar(f"{k}_best", v, step=info.get("step", 0))
    return info["params"], info
