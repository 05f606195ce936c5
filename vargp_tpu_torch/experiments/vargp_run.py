"""VAR-GP experiment drivers; counterpart of
``vargp_tpu/experiments/vargp_run.py`` (the reference's
experiments/vargp.py), with the reference's default hyperparameters and
task protocols:

  - toy: 2 tasks x 2 classes, epochs=5000, M=20, lr=1e-2, beta=1.0
  - s_mnist: 5 tasks, classes {2t, 2t+1}, val/test on classes seen so far,
    epochs=500, M=60, lr=3e-3, beta=10.0, patience=20
  - s_digits: the Split-MNIST protocol on scikit-learn's real 8x8 digits
  - p_mnist: 10 tasks of pixel permutations (task 0 unpermuted),
    epochs=1000, M=100, lr=3.7e-3, beta=1.64

Every driver runs on ``device`` (None means the card).  Task t trains
from a generator derived from (seed, t) alone, so ``resume=True``, which
reloads the finished tasks' ``ckpt{t}.npz`` and trains on from the first
missing one, gives the chain an uninterrupted run gives.  Multi-device
runs (``n_devices``, ``model_parallel``) are not ported yet and raise.
"""

import json
import os

import numpy as np

from vargp_tpu_torch import data
from vargp_tpu_torch.data.tasks import concat
from vargp_tpu_torch.experiments.analysis import params_template
from vargp_tpu_torch.models.vargp import VARGPConfig
from vargp_tpu_torch.ops.device import resolve_device
from vargp_tpu_torch.train.loop import _MULTI_DEVICE, TrainHyperparams, train_task
from vargp_tpu_torch.utils.checkpoint import load_pytree, save_chain
from vargp_tpu_torch.utils.convert import params_from_numpy
from vargp_tpu_torch.utils.logging import MetricsLogger
from vargp_tpu_torch.utils.prng import seed_everything, task_generator


def _log_dir(name: str) -> str:
    base = os.environ.get("VARGP_TPU_LOGDIR", "runs")
    return os.path.join(base, name)


def _device(device, n_devices=None, model_parallel=None):
    """The run's device, resolved before any data is loaded (no card and
    no ``device="cpu"`` raises at once); multi-device arguments raise."""
    if n_devices is not None or model_parallel is not None:
        raise NotImplementedError(_MULTI_DEVICE)
    return resolve_device(device)


def _run_task_stream(name, tasks, cfg, hp, seed, log_dir=None, ls_init=None, resume=False,
                     meta=None, device=None):
    """The continual loop: train each task, grow the chain, save
    ``ckpt{t}.npz``.  ``resume=True`` reloads the tasks whose checkpoint
    exists in ``log_dir`` and trains the rest."""
    root, seed = seed_everything(seed)
    dev = resolve_device(device)
    log_dir = log_dir or _log_dir(name)
    chain, summaries, shared = [], [], {}
    if meta:
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "run_meta.json"), "w") as f:
            json.dump(meta, f, indent=2)
        print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in meta.items()))
    with MetricsLogger(log_dir) as logger:
        for t, (train_set, val_set, test_set) in enumerate(tasks):
            ckpt_path = os.path.join(log_dir, f"ckpt{t}.npz")
            if resume and os.path.exists(ckpt_path):
                tree = load_pytree(ckpt_path, params_template(cfg))
                chain.append(params_from_numpy(tree, device=dev)[0])
                summaries.append({})
                print(f"[{name}] task {t}: resumed from {ckpt_path}")
                continue
            params, info = train_task(
                task_generator(root, t, dev), t, train_set, val_set, test_set, cfg, hp,
                prev_chain=chain, logger=logger, seed=seed + t, ls_init=ls_init,
                shared=shared, device=dev,
            )
            chain.append(params)
            save_chain(log_dir, t, params)
            summaries.append(info.get("acc_summary", {}))
            print(
                f"[{name}] task {t}: "
                + " ".join(f"{k.split('/')[-2]}={v:.4f}"
                           for k, v in info.get("acc_summary", {}).items())
                + f" (best at epoch {info['step']}; {info['steps_per_sec']:.4f} steps/s,"
                f" {info['steps']} steps, {info['epochs']} epochs)"
            )
    return chain, summaries


def toy(epochs=5000, M=20, lr=1e-2, batch_size=512, beta=1.0, n_f=10, n_var_samples=3,
        ep_var_mean=True, map_est_hypers=False, dkl=False, seed=None, eval_interval=10,
        log_dir=None, n_tasks=2, ls_init=None, resume=False, n_devices=None,
        model_parallel=None, device=None):
    """The toy protocol (the reference's experiments/vargp.py:76-104;
    patience disabled)."""
    device = _device(device, n_devices, model_parallel)
    toy_all = data.make_toy_dataset(seed=seed or 0)

    def tasks():
        for t in range(n_tasks):
            train_set = data.filter_by_class(toy_all, [2 * t, 2 * t + 1])
            seen = data.filter_by_class(toy_all, range(2 * t + 2))
            yield train_set, seen, seen

    cfg = VARGPConfig(
        M=M, out_size=4, in_size=2, n_f=n_f, n_var_samples=n_var_samples,
        ep_var_mean=bool(ep_var_mean), map_est_hypers=bool(map_est_hypers), dkl=bool(dkl),
    )
    # every task trains on len/n_classes*2 rows; pad to the larger of that
    # and one batch so small batch sizes still fit the dataset
    task_rows = 2 * (len(toy_all) // 4)
    hp = TrainHyperparams(
        epochs=epochs, lr=lr, batch_size=batch_size, beta=beta,
        eval_interval=eval_interval, patience=-1,
        pad_tasks_to=n_tasks, pad_data_rows=max(batch_size, task_rows),
        pad_eval_batches=-(-len(toy_all) // batch_size),
    )
    return _run_task_stream("toy", tasks(), cfg, hp, seed, log_dir, ls_init=ls_init,
                            resume=resume, device=device)


def split_mnist(data_dir=None, epochs=500, M=60, lr=3e-3, batch_size=512, beta=10.0, n_f=10,
                n_var_samples=3, ep_var_mean=True, map_est_hypers=False, dkl=False, seed=None,
                eval_interval=10, patience=20, log_dir=None, n_tasks=5, ls_init=None,
                resume=False, n_devices=None, model_parallel=None, pad_tasks_to=None,
                device=None):
    """Split-MNIST (the reference's experiments/vargp.py:107-140), on the
    synthetic surrogate when no IDX files are found.  The chain is padded
    to ``pad_tasks_to`` tasks (default ``n_tasks``): a short run of the
    first tasks can keep the full protocol's chain width."""
    device = _device(device, n_devices, model_parallel)
    rng = np.random.default_rng(seed or 0)
    mnist_train_full = data.load_mnist(data_dir, train=True)
    mnist_test = data.load_mnist(data_dir, train=False)
    train_all, val_all = data.split_train_val(mnist_train_full, 10000, rng)

    def tasks():
        for t in range(n_tasks):
            train_set = data.filter_by_class(train_all, [2 * t, 2 * t + 1])
            val_set = data.filter_by_class(val_all, range(2 * t + 2))
            test_set = data.filter_by_class(mnist_test, range(2 * t + 2))
            yield train_set, val_set, test_set

    cfg = VARGPConfig(
        M=M, out_size=10, in_size=784, n_f=n_f, n_var_samples=n_var_samples,
        ep_var_mean=bool(ep_var_mean), map_est_hypers=bool(map_est_hypers), dkl=bool(dkl),
    )
    # padded chain: the same shapes for every task of the run
    counts = np.bincount(train_all.targets, minlength=2 * n_tasks)
    max_train = int(max(counts[2 * t] + counts[2 * t + 1] for t in range(n_tasks)))
    max_eval_rows = max(
        max_train,
        int(np.sum(np.bincount(val_all.targets, minlength=2 * n_tasks)[: 2 * n_tasks])),
        int(np.sum(np.bincount(mnist_test.targets, minlength=2 * n_tasks)[: 2 * n_tasks])),
    )
    hp = TrainHyperparams(
        epochs=epochs, lr=lr, batch_size=batch_size, beta=beta,
        eval_interval=eval_interval, patience=patience,
        pad_tasks_to=n_tasks if pad_tasks_to is None else int(pad_tasks_to),
        pad_data_rows=max_train,
        pad_eval_batches=-(-max_eval_rows // batch_size),
    )
    return _run_task_stream(
        "s_mnist", tasks(), cfg, hp, seed, log_dir, ls_init=ls_init, resume=resume,
        meta={"data_source": data.mnist_source(data_dir)}, device=device,
    )


def split_digits(epochs=500, M=20, lr=3e-3, batch_size=512, beta=10.0, n_f=10, n_var_samples=3,
                 ep_var_mean=True, map_est_hypers=False, dkl=False, seed=None, eval_interval=10,
                 patience=20, log_dir=None, n_tasks=5, ls_init=None, resume=False,
                 eval_resample_per_batch=False, n_devices=None, model_parallel=None,
                 phi_lr=None, phi_wd=0.0, freeze_phi=False, device=None):
    """Split-Digits: the Split-MNIST protocol on scikit-learn's real 8x8
    digits (scikit-learn must be installed: without it loading raises
    ``ImportError``).  ``phi_lr`` / ``phi_wd`` / ``freeze_phi`` are the
    deep kernel's feature-map knobs (no effect unless ``dkl``)."""
    device = _device(device, n_devices, model_parallel)
    rng = np.random.default_rng(seed or 0)
    train_full = data.load_digits_dataset(train=True, seed=0)
    test_full = data.load_digits_dataset(train=False, seed=0)
    # a fifth of the training rows as validation
    train_all, val_all = data.split_train_val(train_full, len(train_full) // 5, rng)

    def tasks():
        for t in range(n_tasks):
            train_set = data.filter_by_class(train_all, [2 * t, 2 * t + 1])
            val_set = data.filter_by_class(val_all, range(2 * t + 2))
            test_set = data.filter_by_class(test_full, range(2 * t + 2))
            yield train_set, val_set, test_set

    cfg = VARGPConfig(
        M=M, out_size=10, in_size=64, n_f=n_f, n_var_samples=n_var_samples,
        ep_var_mean=bool(ep_var_mean), map_est_hypers=bool(map_est_hypers), dkl=bool(dkl),
    )
    counts = np.bincount(train_all.targets, minlength=2 * n_tasks)
    max_train = int(max(counts[2 * t] + counts[2 * t + 1] for t in range(n_tasks)))
    max_eval_rows = max(max_train, len(val_all), len(test_full))
    hp = TrainHyperparams(
        epochs=epochs, lr=lr, batch_size=batch_size, beta=beta,
        eval_interval=eval_interval, patience=patience,
        pad_tasks_to=n_tasks, pad_data_rows=max(batch_size, max_train),
        pad_eval_batches=-(-max_eval_rows // batch_size),
        eval_resample_per_batch=bool(eval_resample_per_batch),
        phi_lr=None if phi_lr is None else float(phi_lr),
        phi_weight_decay=float(phi_wd),
        freeze_phi_after_first=bool(freeze_phi),
    )
    return _run_task_stream(
        "s_digits", tasks(), cfg, hp, seed, log_dir, ls_init=ls_init, resume=resume,
        meta={"data_source": "sklearn-digits (real)"}, device=device,
    )


def permuted_mnist(data_dir=None, n_tasks=10, epochs=1000, M=100, lr=3.7e-3, batch_size=512,
                   beta=1.64, n_f=10, n_var_samples=3, ep_var_mean=True, map_est_hypers=False,
                   dkl=False, seed=None, eval_interval=10, patience=20, log_dir=None,
                   ls_init=None, resume=False, padded_chain=False, n_devices=None,
                   model_parallel=None, device=None):
    """Permuted-MNIST (the reference's experiments/vargp.py:143-186): task
    0 unpermuted; validation and test accumulate every permutation seen.
    ``padded_chain=True`` pads every task's chain to ``n_tasks``; False
    (default) gives task t a chain of t + 1 tasks."""
    device = _device(device, n_devices, model_parallel)
    rng = np.random.default_rng(seed or 0)
    mnist_train_full = data.load_mnist(data_dir, train=True)
    mnist_test_full = data.load_mnist(data_dir, train=False)
    train_all, val_all = data.split_train_val(mnist_train_full, 10000, rng)
    perms = data.make_permutations(n_tasks, 784, rng)

    def tasks():
        val_seen, test_seen = [], []
        for t in range(n_tasks):
            train_set = data.apply_permutation(train_all, perms[t])
            val_seen.append(data.apply_permutation(val_all, perms[t]))
            test_seen.append(data.apply_permutation(mnist_test_full, perms[t]))
            yield train_set, concat(val_seen), concat(test_seen)

    cfg = VARGPConfig(
        M=M, out_size=10, in_size=784, n_f=n_f, n_var_samples=n_var_samples,
        ep_var_mean=bool(ep_var_mean), map_est_hypers=bool(map_est_hypers), dkl=bool(dkl),
    )
    max_eval_rows = n_tasks * max(len(val_all), len(mnist_test_full))
    hp = TrainHyperparams(
        epochs=epochs, lr=lr, batch_size=batch_size, beta=beta,
        eval_interval=eval_interval, patience=patience,
        pad_tasks_to=n_tasks if padded_chain else None,
        pad_data_rows=len(train_all),
        pad_eval_batches=-(-max_eval_rows // batch_size) if padded_chain else None,
    )
    return _run_task_stream(
        "p_mnist", tasks(), cfg, hp, seed, log_dir, ls_init=ls_init, resume=resume,
        meta={"data_source": data.mnist_source(data_dir)}, device=device,
    )


def _completed_sweep_acc(m_dir, n_tasks):
    """A finished sweep point's metric from its metrics.jsonl: the last
    ``task{n_tasks-1}/test/acc_best`` record (what a fresh run's summary
    reports), or None when the run never reached the final task."""
    path = os.path.join(m_dir, "metrics.jsonl")
    if not os.path.exists(path):
        return None
    want = f"task{n_tasks - 1}/test/acc_best"
    acc = None
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("tag") == want:
                acc = rec["value"]
    return acc


def varying_m(ms=(20, 40, 60, 80, 100, 120, 140, 160, 180, 200), data_dir=None, epochs=500,
              lr=3e-3, batch_size=512, beta=10.0, seed=None, patience=20, log_dir=None,
              n_tasks=5, dataset="s_mnist", resume=False, **kwargs):
    """The inducing-point sweep: the final task's test accuracy against M
    (the reference's mnist.ipynb cell 17), on ``dataset`` "s_mnist" or
    "s_digits"; writes ``varying_M.json``.  ``resume=True`` reads back the
    points whose directory holds a finished run of the same configuration
    (``sweep_point.json``) and resumes the rest from their checkpoints; a
    point with no final accuracy raises rather than record 0.0.  The figure
    waits for ``plots.py`` (ROADMAP Queue A item 5)."""
    if dataset not in ("s_mnist", "s_digits"):
        raise ValueError(f"dataset={dataset!r}: expected s_mnist or s_digits")
    base = log_dir or _log_dir(f"varying_m_{dataset}" if dataset != "s_mnist" else "varying_m")
    results = {}
    for m in ms:
        m_dir = os.path.join(base, f"M{m}")
        point_cfg = dict(
            dataset=dataset, M=int(m), epochs=epochs, lr=lr, batch_size=batch_size, beta=beta,
            seed=seed, patience=patience, n_tasks=n_tasks,
        )
        stamp_path = os.path.join(m_dir, "sweep_point.json")
        if resume:
            stamp = None
            if os.path.exists(stamp_path):
                with open(stamp_path) as f:
                    stamp = json.load(f)
            acc = _completed_sweep_acc(m_dir, n_tasks) if stamp == point_cfg else None
            if acc is not None:
                results[int(m)] = float(acc)
                print(f"[varying_m] M={m}: resumed, final test acc {acc:.4f}")
                continue
        common = dict(
            epochs=epochs, M=int(m), lr=lr, batch_size=batch_size, beta=beta, seed=seed,
            patience=patience, log_dir=m_dir, n_tasks=n_tasks, resume=resume, **kwargs,
        )
        if dataset == "s_digits":
            _, summaries = split_digits(**common)
        else:
            _, summaries = split_mnist(data_dir=data_dir, **common)
        os.makedirs(m_dir, exist_ok=True)
        with open(stamp_path, "w") as f:
            json.dump(point_cfg, f, indent=2)
        final = summaries[-1] if summaries else {}
        acc = next((v for k, v in final.items() if k.endswith("test/acc")), None)
        if acc is None:
            # every task reloaded from its checkpoint: the metric is in the
            # run's own metrics file
            acc = _completed_sweep_acc(m_dir, n_tasks)
        if acc is None:
            raise RuntimeError(
                f"varying_m M={m}: no final-task test accuracy in summaries"
                f" or {m_dir}/metrics.jsonl — refusing to record a bogus 0.0"
            )
        results[int(m)] = float(acc)
        print(f"[varying_m] M={m}: final test acc {acc:.4f}")
    os.makedirs(base, exist_ok=True)
    with open(os.path.join(base, "varying_M.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results
