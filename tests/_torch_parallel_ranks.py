"""Rank bodies for the port's sharded CPU tests (``test_torch_parallel.py``,
``test_torch_partition.py``).  Each runs in a spawned gloo rank
(``vargp_tpu_torch.parallel.spawn_ranks``), so this module imports torch
and the port only: no JAX, which would slow every rank's start.

A case file (``torch.save``) holds the port's inputs, made by the test
from numpy and the JAX package's draws; each rank shards them itself, runs
the sharded functions and returns what the test compares, gathered whole
(``unshard_to_host``) or as this rank's rows with its coordinates."""

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vargp_tpu_torch import parallel
from vargp_tpu_torch.parallel import distributed
from vargp_tpu_torch.train import loop as TL


def _rank_setup(model_parallel):
    # one intra-op thread: several ranks share the test worker's cores
    torch.set_num_threads(1)
    n = torch.distributed.get_world_size()
    return parallel.make_mesh(n, model_parallel, devices=["cpu"] * n)


def _step(c, mesh, log=False):
    """One sharded ELBO step of case ``c``: the loss, the pieces, the
    parameters and optimizer state after it (whole), the collectives."""
    O = c["cfg"].out_size
    opt = TL.make_optimizer(TL.TrainHyperparams(lr=c["lr"]))
    update = parallel.make_sharded_update_fn(c["cfg"], opt, c["beta"], c["n_train"], mesh)
    p = parallel.shard_params(c["params"], mesh, O)
    prev = parallel.shard_params(c["prev"], mesh, O)
    s = opt.init(p)
    x, y, w = parallel.shard_batch(c["x"], c["y"], c["w"], mesh)
    mesh.log.clear()
    p, s, loss, pieces = update(p, s, prev, c["prior"], x, y, w, c["noise"],
                                chain_mask=c.get("mask"))
    collectives = list(mesh.log)
    return dict(loss=float(loss), pieces=[float(v) for v in pieces],
                params=parallel.unshard_to_host(p, mesh, O),
                opt=parallel.unshard_to_host(s, mesh, O), log=collectives if log else None)


def mesh_checks(case_path, model_parallel):
    """Every check of one mesh shape, in one job."""
    mesh = _rank_setup(model_parallel)
    case = torch.load(case_path, weights_only=False)
    out = dict(shape=mesh.shape, coords=mesh.coords)
    out["plain"] = _step(case["plain"], mesh, log=True)
    out["dkl"] = _step(case["dkl"], mesh)

    b = case["block"]
    O = b["cfg"].out_size
    opt = TL.make_optimizer(TL.TrainHyperparams(lr=b["lr"]))
    run = parallel.make_sharded_device_train_fn(b["cfg"], opt, b["beta"], b["batch_size"],
                                                b["n_epochs"], mesh)
    p = parallel.shard_params(b["params"], mesh, O)
    prev = parallel.shard_params(b["prev"], mesh, O)
    p, s, losses, pieces = run(p, opt.init(p), prev, b["prior"], b["mask"], b["n_train"],
                               *b["data"], torch.Generator().manual_seed(b["seed"]))
    out["block"] = dict(losses=losses, pieces=pieces,
                        params=parallel.unshard_to_host(p, mesh, O))

    e = case["eval"]
    rows = mesh.row_slice(e["xs"].shape[1])
    p = parallel.shard_params(e["params"], mesh, O)
    prev = parallel.shard_params(e["prev"], mesh, O)
    counts = {}
    for name, hp in e["hps"].items():
        ev = TL.make_device_eval_fn(e["cfg"], hp, mesh)
        correct, total = ev(p, prev, e["mask"], e["xs"][:, rows], e["ys"][:, rows],
                            e["ws"][:, rows], e["draws"][name], device="cpu")
        counts[name] = (float(correct), float(total))
    out["eval"] = counts
    predict = parallel.make_sharded_predict_fn(e["cfg"], mesh)
    with torch.no_grad():
        out["predict"] = (rows, predict(p, prev, e["xs"][0, rows], e["pnoise"], e["mask"]))

    # the sharding round trip, and the whole tree's leaves on every rank
    out["round_trip"] = parallel.unshard_to_host(p, mesh, O)
    return out


def fail_on_rank_one():
    """Rank 1 raises; rank 0 waits in a collective for it."""
    if torch.distributed.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    torch.distributed.all_reduce(torch.ones(1))


def job_checks():
    """The mesh rules in a job of two CPU ranks, and ``initialize``'s
    second call."""
    torch.set_num_threads(1)
    errors = {}
    for label, kw in (("more than the world", dict(n_devices=4, devices=["cpu"] * 4)),
                      ("fewer than the world", dict(n_devices=1, devices=["cpu"])),
                      ("not divisible", dict(n_devices=2, model_parallel=3,
                                             devices=["cpu"] * 2)),
                      ("too few devices", dict(n_devices=2, devices=["cpu"]))):
        try:
            parallel.make_mesh(**kw)
        except ValueError as exc:
            errors[label] = str(exc)
    mesh = parallel.make_mesh(2, devices=["cpu"] * 2)
    for label, fn in (("odd classes", lambda: mesh.class_slice(3)),
                      ("odd rows", lambda: parallel.make_mesh(2, 1, devices=["cpu"] * 2)
                       .row_slice(5))):
        try:
            fn()
        except ValueError as exc:
            errors[label] = str(exc)
    distributed.initialize("localhost:1", 2, 0, device="cpu")  # joined: a no-op
    return dict(errors=errors, shape=mesh.shape, world=torch.distributed.get_world_size(),
                backend=torch.distributed.get_backend(), default=parallel.global_mesh().shape)


class _KernelCalls(TorchDispatchMode):
    """Records each ``vargp_torch::`` operator call and its tensors' shapes."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        if name.startswith("vargp_torch::"):
            self.calls.append((name, [tuple(a.shape) for a in args
                                      if isinstance(a, torch.Tensor)]))
        return func(*args, **(kwargs or {}))


def partition_checks(case_path, model_parallel):
    """The kernels' plain versions on this rank's shard against the slice
    of the whole; the operators one sharded step calls, with their
    shapes, and its collectives."""
    from vargp_tpu_torch.gpmath.linalg import chol_and_inv_blocked
    from vargp_tpu_torch.kernels import cross_gram, deep_gram, sym_gram

    mesh = _rank_setup(model_parallel)
    case = torch.load(case_path, weights_only=False)
    k = case["kernels"]
    cs = mesh.class_slice(k["z"].shape[0])
    rs = mesh.row_slice(k["x"].shape[0])
    z_local = parallel.shard_params(k["z"], mesh, k["z"].shape[0])
    x_local = parallel.shard_batch(k["x"], k["x"][:, 0], k["x"][:, 0], mesh)[0]
    theta, phi = k["theta"], k["phi"]
    K1 = sym_gram(theta, z_local), sym_gram(theta, k["z"])[:, cs]
    K4 = cross_gram(theta, z_local, x_local), cross_gram(theta, k["z"], k["x"])[:, cs, :, rs]
    K5 = (deep_gram(phi, k["theta_dkl"], z_local),
          deep_gram(phi, k["theta_dkl"], k["z"])[:, cs])
    K3 = (chol_and_inv_blocked(k["K"][:, cs].contiguous(), k["block"]),
          tuple(t[:, cs] for t in chol_and_inv_blocked(k["K"], k["block"])))
    pairs = dict(sym_gram=K1, cross_gram=K4, rbf_gram=K5, chol=(K3[0][0], K3[1][0]),
                 chol_inv=(K3[0][1], K3[1][1]))

    with _KernelCalls() as calls:
        step = _step(case["plain"], mesh, log=True)
    return dict(shape=mesh.shape, pairs=pairs, calls=calls.calls, log=step["log"],
                loss=step["loss"])
