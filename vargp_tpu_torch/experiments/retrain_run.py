"""The VAR-GP Retrain driver; counterpart of
``vargp_tpu/experiments/retrain_run.py`` (the reference's
experiments/vargp_retrain.py, toy only, with T > 2 tasks handled):

  - toy_retrain: tasks of 2 classes of the 4-cluster toy, M=20 a task,
    epochs=5000, lr=1e-2, beta=1.0, patience disabled, an evaluation of
    the classes seen so far every ``eval_interval`` epochs

Every task's raw parameters stay trainable; the previous tasks' trained
values are also frozen into the importance term's snapshot, and the
previous kernel posterior is the next kernel prior.  The run happens on
``device`` (None means the card; no card raises before any data loads).

Randomness comes from one draw source per task (``RetrainDraws`` over
the task's ``torch.Generator``, derived from (seed, t) alone): the
inducing rows, the initial parameters' noise, each block's permutations
and per-step noise, each evaluation's noise (one hyper sample set and one
set of function samples for the whole split, as the JAX driver draws one
key an evaluation) and the final evaluation's.  A test replays the JAX
keys through the same seam (``task_draws``).
"""

import time

import numpy as np
import torch

from vargp_tpu_torch import data
from vargp_tpu_torch.experiments.vargp_run import _log_dir
from vargp_tpu_torch.models import vargp_retrain as R
from vargp_tpu_torch.ops.device import resolve_device
from vargp_tpu_torch.train.loop import (
    GeneratorDraws,
    TrainHyperparams,
    epoch_blocks,
    finite_pieces,
    gradient_step,
    make_optimizer,
    pad_dataset_to_device,
    step_block,
)
from vargp_tpu_torch.train.metrics import compute_accuracy
from vargp_tpu_torch.utils.checkpoint import save_chain
from vargp_tpu_torch.utils.logging import MetricsLogger
from vargp_tpu_torch.utils.prng import seed_everything, task_generator


def draw_noise(gen: torch.Generator, cfg: R.RetrainConfig, S: int, c: int,
               batch_size: int) -> dict:
    """One step's ``noise`` for ``R.loss``, standard normal from ``gen`` on
    its device, in the JAX loss's key order: hyper samples, function
    samples and, with c frozen rows, the draws of u_{<=t} (S chain rows)
    and of u~_{<t}."""
    H = 1 if cfg.map_est_hypers else cfg.n_var_samples
    n_v, O = cfg.n_var_samples, cfg.out_size

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=gen.device)

    noise = {"hyper_eps": normal(n_v, cfg.in_size + 1),
             "lik_eps": normal(H, cfg.n_f, O, batch_size)}
    if c:
        noise["u_eps"] = normal(n_v, H, O, S)
        noise["ut_eps"] = normal(n_v, n_v, H, O, c)
    return noise


class RetrainDraws(GeneratorDraws):
    """A task's draws from one ``torch.Generator``, on its device:
    ``inducing`` (the new task's rows), ``init`` (kernel_eps, u_eps),
    ``block`` (a train block's row indices and noise, step by step, the
    noise Retrain's with S chain rows and c frozen rows), ``evaluation``
    (one evaluation's hyper_eps and lik_eps for every batch of the split)
    and ``final`` (the same for the accuracy after the task)."""

    draw_noise = staticmethod(draw_noise)

    def init(self, cfg: R.RetrainConfig) -> dict:
        return {"kernel_eps": self._normal(cfg.in_size + 1),
                "u_eps": self._normal(cfg.out_size, cfg.M, 1)}

    def evaluation(self, cfg: R.RetrainConfig, batch_size: int) -> dict:
        H = 1 if cfg.map_est_hypers else cfg.n_var_samples
        return {"hyper_eps": self._normal(cfg.n_var_samples, cfg.in_size + 1),
                "lik_eps": self._normal(H, cfg.n_f, cfg.out_size, batch_size)}

    final = evaluation


def elbo(params, frozen_prev, prior, x, y, w, noise, *, cfg: R.RetrainConfig, beta: float,
         n_train, device=None):
    """``train.loop.gradient_step``'s objective: (beta * kl_hypers + kl_u +
    (n_train / sum(w)) * nll, (kl_hypers, kl_u, nll))."""
    klh, klu, nll = R.loss(params, frozen_prev, prior, x, y, noise, cfg, weights=w,
                           device=device)
    scale = n_train / torch.clamp(torch.sum(w), min=1.0)
    return beta * klh + klu + scale * nll, (klh, klu, nll)


def accuracy(params, ds, noise: dict, cfg: R.RetrainConfig, batch_size: int, *,
             device=None) -> float:
    """Top-1 accuracy over ``ds`` in fixed-shape batches, every batch on the
    same ``noise`` (one theta and one set of function samples for the
    split)."""
    dev = resolve_device(device)

    def predict(xb):
        with torch.no_grad():
            return R.predict(params, torch.from_numpy(xb).to(dev), noise, cfg, device=dev)

    return compute_accuracy(ds, predict, batch_size)


def train_task(draws, task_id: int, train_set, seen, cfg: R.RetrainConfig, hp: TrainHyperparams,
               prev_raw=(), kernel_prior_from=None, logger=None, *, device=None):
    """Train task ``task_id`` with the previous tasks' raw parameters
    ``prev_raw`` trainable again; returns (params, info).  Blocks of
    epochs end on the evaluation cadence (``train.loop.epoch_blocks``);
    every ``hp.eval_interval`` epochs ``seen`` is evaluated and logged as
    ``task{t}/test/acc``.  A non-finite ELBO piece at an evaluation
    raises.  ``info`` holds the final accuracy on ``seen`` (on the draw
    source's ``final`` noise), the last step's pieces, steps_per_sec,
    steps and epochs."""
    dev = resolve_device(device)
    x_train = torch.from_numpy(np.ascontiguousarray(train_set.data)).to(dev)
    z_init = draws.inducing(x_train, cfg.M, cfg.out_size)
    init = draws.init(cfg)
    params, prior, frozen = R.init_params(init["kernel_eps"], init["u_eps"], z_init, cfg,
                                          prev_chain=prev_raw,
                                          kernel_prior_from=kernel_prior_from)
    opt = make_optimizer(hp)
    opt_state = opt.init(params)
    n_train = torch.tensor(float(len(train_set)), device=dev)
    data_x, data_y, data_w = pad_dataset_to_device(train_set.data, train_set.targets,
                                                   hp.batch_size, device=dev)
    n_pad = data_x.shape[0]
    steps_per_epoch = n_pad // hp.batch_size
    S = sum(t.z.shape[-2] for t in params.tasks)
    c = sum(p.z.shape[-2] for p in frozen)

    def step(params, opt_state, x, y, w, noise):
        return gradient_step(params, opt_state, lambda p: elbo(
            p, frozen, prior, x, y, w, noise, cfg=cfg, beta=hp.beta, n_train=n_train,
            device=dev), opt)

    t_start = time.time()
    steps, done, pieces = 0, 0, None
    for n_epochs, done in epoch_blocks(hp, steps_per_epoch):
        params, opt_state, _, pieces = step_block(
            step, params, opt_state, draws.block(n_pad, hp.batch_size, n_epochs, cfg, S, c),
            data_x, data_y, data_w)
        steps += n_epochs * steps_per_epoch
        if done % hp.eval_interval == 0:
            finite_pieces(pieces, ("kl_hypers", "kl_u", "nll"), done)
            acc = accuracy(params, seen, draws.evaluation(cfg, hp.batch_size), cfg,
                           hp.batch_size, device=dev)
            if logger is not None:
                logger.add_scalar(f"task{task_id}/test/acc", acc, step=done)
    steps_per_sec = steps / max(time.time() - t_start, 1e-9)
    acc = accuracy(params, seen, draws.final(cfg, hp.batch_size), cfg, hp.batch_size, device=dev)
    return params, dict(acc=acc, pieces=None if pieces is None else pieces[-1].tolist(),
                        steps_per_sec=steps_per_sec, steps=steps, epochs=done)


def toy(epochs=5000, M=20, lr=1e-2, batch_size=512, beta=1.0, n_f=10, n_var_samples=3,
        seed=None, eval_interval=10, log_dir=None, n_tasks=2, device=None, task_draws=None):
    """The toy Retrain protocol: task t trains classes {2t, 2t+1} and is
    evaluated on every class seen so far; each task's parameters are saved
    as ``ckpt{t}.npz`` as it finishes.  The dataset's seed is ``seed or
    0`` even for a random run (``seed=None``), so the ablation trains on
    the 4-cluster data of the VAR-GP toy it is compared with.
    ``task_draws(t)`` replaces task t's draw source (default
    ``RetrainDraws`` over ``task_generator(seed, t)``).  Returns (the last
    task's parameters, the tasks' final accuracy summaries)."""
    device = resolve_device(device)
    data_seed = seed or 0
    root, seed = seed_everything(seed)
    log_dir = log_dir or _log_dir("toy_retrain")
    toy_all = data.make_toy_dataset(seed=data_seed)
    cfg = R.RetrainConfig(M=M, out_size=4, in_size=2, n_f=n_f, n_var_samples=n_var_samples)
    hp = TrainHyperparams(epochs=epochs, lr=lr, batch_size=batch_size, beta=beta,
                          eval_interval=eval_interval, patience=-1)
    if task_draws is None:
        task_draws = lambda t: RetrainDraws(task_generator(root, t, device))  # noqa: E731

    prev_raw, kernel_prior_from, params, summaries = (), None, None, []
    with MetricsLogger(log_dir) as logger:
        for t in range(n_tasks):
            train_set = data.filter_by_class(toy_all, [2 * t, 2 * t + 1])
            seen = data.filter_by_class(toy_all, range(2 * t + 2))
            params, info = train_task(task_draws(t), t, train_set, seen, cfg, hp,
                                      prev_raw=prev_raw, kernel_prior_from=kernel_prior_from,
                                      logger=logger, device=device)
            prev_raw, kernel_prior_from = params.tasks, params.kernel
            save_chain(log_dir, t, params)
            summaries.append({f"task{t}/test/acc": info["acc"]})
            print(f"[toy_retrain] task {t}: test acc {info['acc']:.4f} "
                  f"({info['steps_per_sec']:.4f} steps/s, {info['steps']} steps, "
                  f"{info['epochs']} epochs)")
    return params, summaries
