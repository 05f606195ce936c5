"""Global continual SVGP drivers; counterpart of
``vargp_tpu/experiments/global_run.py`` (the reference's
experiments/toy_global.py and mnist_global.py, in working form), with
their default hyperparameters and task protocols:

  - toy_global: 2 tasks x 2 classes, M = 20 (t + 1) growing, epochs=10000,
    lr=1e-2, beta=1.0, patience disabled
  - s_mnist_global: 5 tasks, classes {2t, 2t+1}, val/test on the classes
    seen so far, M=60 (+ grow_per_task t), epochs=500, lr=3e-3, beta=10.0,
    patience=20
  - p_mnist_global: 10 permutation tasks, M=100 (+ grow_per_task t),
    epochs=1000, lr=3.7e-3, beta=1.64, patience=20

Every driver runs on ``device`` (None means the card; no card raises
before any data loads).  Task t trains from a generator derived from
(seed, t) alone, and task t's best parameters are saved as
``ckpt{t}.npz`` as soon as it finishes; the next task is regularised by
them.
"""

import numpy as np

from vargp_tpu_torch import data
from vargp_tpu_torch.data.tasks import concat
from vargp_tpu_torch.experiments.vargp_run import _log_dir
from vargp_tpu_torch.models.global_svgp import GlobalSVGPConfig
from vargp_tpu_torch.ops.device import resolve_device
from vargp_tpu_torch.train.loop import TrainHyperparams
from vargp_tpu_torch.train.loop_global import train_task
from vargp_tpu_torch.utils.checkpoint import save_chain
from vargp_tpu_torch.utils.logging import MetricsLogger
from vargp_tpu_torch.utils.prng import seed_everything, task_generator


def _run(name, tasks, hp, seed, log_dir=None, device=None):
    """The continual loop: train each (train, val, test, cfg) task with the
    previous task's best parameters as its regulariser, save
    ``ckpt{t}.npz``.  Returns (the last task's parameters, the tasks'
    accuracy summaries)."""
    root, seed = seed_everything(seed)
    log_dir = log_dir or _log_dir(name)
    prev_params = None
    summaries = []
    with MetricsLogger(log_dir) as logger:
        for t, (train_set, val_set, test_set, cfg) in enumerate(tasks):
            params, info = train_task(
                task_generator(root, t, device), t, train_set, val_set, test_set, cfg, hp,
                prev_state=prev_params, logger=logger, seed=seed + t, device=device,
            )
            prev_params = params
            save_chain(log_dir, t, params)
            summaries.append(info.get("acc_summary", {}))
            print(
                f"[{name}] task {t}: "
                + " ".join(f"{k.split('/')[-2]}={v:.4f}"
                           for k, v in info.get("acc_summary", {}).items())
                + f" (best at epoch {info['step']}; {info['steps_per_sec']:.4f} steps/s,"
                f" {info['steps']} steps, {info['epochs']} epochs)"
            )
    return prev_params, summaries


def toy_global(epochs=10000, M=20, lr=1e-2, batch_size=512, beta=1.0, n_f=10, n_var_samples=3,
               map_est_hypers=False, seed=None, eval_interval=10, log_dir=None, device=None):
    """The toy protocol with M growing as M (t + 1)."""
    device = resolve_device(device)
    toy_all = data.make_toy_dataset(seed=seed or 0)

    def tasks():
        for t in range(2):
            train_set = data.filter_by_class(toy_all, [2 * t, 2 * t + 1])
            seen = data.filter_by_class(toy_all, range(2 * t + 2))
            cfg = GlobalSVGPConfig(
                M=M * (t + 1), out_size=4, in_size=2, n_f=n_f, n_var_samples=n_var_samples,
                map_est_hypers=bool(map_est_hypers),
            )
            yield train_set, seen, seen, cfg

    hp = TrainHyperparams(epochs=epochs, lr=lr, batch_size=batch_size, beta=beta,
                          eval_interval=eval_interval, patience=-1)
    return _run("toy_global", tasks(), hp, seed, log_dir, device)


def split_mnist(data_dir=None, epochs=500, M=60, lr=3e-3, batch_size=512, beta=10.0, n_f=10,
                n_var_samples=3, map_est_hypers=False, seed=None, eval_interval=10, patience=20,
                log_dir=None, n_tasks=5, grow_per_task=0, device=None):
    """Split-MNIST (the synthetic surrogate without the IDX files); task t
    has M + grow_per_task t inducing rows per class."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed or 0)
    train_full = data.load_mnist(data_dir, train=True)
    test_full = data.load_mnist(data_dir, train=False)
    train_all, val_all = data.split_train_val(train_full, 10000, rng)

    def tasks():
        for t in range(n_tasks):
            train_set = data.filter_by_class(train_all, [2 * t, 2 * t + 1])
            val_set = data.filter_by_class(val_all, range(2 * t + 2))
            test_set = data.filter_by_class(test_full, range(2 * t + 2))
            cfg = GlobalSVGPConfig(
                M=M + grow_per_task * t, out_size=10, in_size=784, n_f=n_f,
                n_var_samples=n_var_samples, map_est_hypers=bool(map_est_hypers),
            )
            yield train_set, val_set, test_set, cfg

    hp = TrainHyperparams(epochs=epochs, lr=lr, batch_size=batch_size, beta=beta,
                          eval_interval=eval_interval, patience=patience)
    return _run("s_mnist_global", tasks(), hp, seed, log_dir, device)


def permuted_mnist(data_dir=None, n_tasks=10, epochs=1000, M=100, lr=3.7e-3, batch_size=512,
                   beta=1.64, n_f=10, n_var_samples=3, seed=None, eval_interval=10, patience=20,
                   log_dir=None, grow_per_task=0, device=None):
    """Permuted-MNIST: task 0 unpermuted; validation and test accumulate
    every permutation seen."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed or 0)
    train_full = data.load_mnist(data_dir, train=True)
    test_full = data.load_mnist(data_dir, train=False)
    train_all, val_all = data.split_train_val(train_full, 10000, rng)
    perms = data.make_permutations(n_tasks, 784, rng)

    def tasks():
        val_seen, test_seen = [], []
        for t in range(n_tasks):
            train_set = data.apply_permutation(train_all, perms[t])
            val_seen.append(data.apply_permutation(val_all, perms[t]))
            test_seen.append(data.apply_permutation(test_full, perms[t]))
            cfg = GlobalSVGPConfig(M=M + grow_per_task * t, out_size=10, in_size=784, n_f=n_f,
                                   n_var_samples=n_var_samples)
            yield train_set, concat(val_seen), concat(test_seen), cfg

    hp = TrainHyperparams(epochs=epochs, lr=lr, batch_size=batch_size, beta=beta,
                          eval_interval=eval_interval, patience=patience)
    return _run("p_mnist_global", tasks(), hp, seed, log_dir, device)
