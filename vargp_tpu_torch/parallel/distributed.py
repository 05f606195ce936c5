"""Multi-process initialisation and local ranks.

Counterpart of ``vargp_tpu/parallel/distributed.py``.  The port runs one
process per rank over ``torch.distributed``; nothing on a machine tells
a program of its cluster, so ``initialize`` takes the coordinator's
address, the number of processes and this process's index (the JAX
CLI's three flags), or reads the launcher's environment (``WORLD_SIZE``,
``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).  ``spawn_ranks`` starts
ranks on one host itself (the drivers' ``n_devices``, the tests).

The backend follows one rule (``backend_for``), never a fallback: NCCL
when every rank has a card of its own, gloo when the ranks are on the
CPU or share a card (NCCL refuses two ranks on one device).
"""

import datetime
import os
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from vargp_tpu_torch.ops.device import resolve_device
from vargp_tpu_torch.parallel.mesh import make_mesh

# a collective waits this long for its peers before it raises
COLLECTIVE_TIMEOUT_S = 600

_JOB = {}  # "devices": one torch.device per rank of the job this process is in


def backend_for(devices) -> str:
    """"nccl" when every rank has a card of its own, else "gloo"."""
    devices = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devices) and len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"


def rank_devices(n: int, device=None) -> list:
    """One device per rank for ``n`` ranks on this host: the CPU for each
    under ``device="cpu"``, else card r for rank r (more ranks than
    visible cards raises, as the JAX package's ``make_mesh`` does)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n
    count = torch.cuda.device_count()
    if n > count:
        raise ValueError(f"requested n_devices={n} but only {count} CUDA device(s) are "
                         "visible; ranks that share a card are started with an explicit "
                         "device list (parallel.spawn_ranks)")
    return [torch.device("cuda", r) for r in range(n)]


def job_devices(n: int) -> list:
    """The job's device list (set by ``initialize`` or ``spawn_ranks``),
    else ``rank_devices(n)``."""
    devices = _JOB.get("devices")
    if devices is not None and len(devices) == n:
        return devices
    return rank_devices(n)


def _parse_address(address) -> str:
    host, sep, port = str(address).rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator_address={address!r}: expected HOST:PORT")
    return f"{host}:{port}"


def initialize(coordinator_address=None, num_processes=None, process_id=None, *, device=None):
    """Join this process to a multi-process job.

    A second call is a no-op.  With no argument and no launcher
    environment (``WORLD_SIZE`` above 1) the process stays single-rank.
    An explicitly requested setup that is malformed raises at once, and
    one that cannot connect raises when the store times out: a
    misconfigured run does not go on single-process.  Process p takes
    card ``LOCAL_RANK`` (else p) modulo the visible cards, or the CPU
    under ``device="cpu"``; the backend follows ``backend_for``, with
    ``LOCAL_WORLD_SIZE`` (else ``num_processes``) ranks on this host."""
    if dist.is_initialized():
        return
    explicit = any(a is not None for a in (coordinator_address, num_processes, process_id))
    env = os.environ
    if not explicit:
        if int(env.get("WORLD_SIZE", "1")) <= 1:
            return
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process job needs coordinator_address, num_processes "
                         "and process_id")
    address = _parse_address(coordinator_address)
    n, pid = int(num_processes), int(process_id)
    if n < 1 or not 0 <= pid < n:
        raise ValueError(f"process_id={pid} of num_processes={n}: expected 0 <= id < n")
    dev = resolve_device(device)
    local_rank = int(env.get("LOCAL_RANK", pid))
    per_host = int(env.get("LOCAL_WORLD_SIZE", n))
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(dev)
        devices = [torch.device("cuda", r % count) for r in range(per_host)]
    else:
        devices = [dev] * per_host
    dist.init_process_group(
        backend_for(devices), init_method=f"tcp://{address}", world_size=n, rank=pid,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    # this rank's device at its place; the others by the same rule
    _JOB["devices"] = [dev if r == pid else devices[r % per_host] for r in range(n)]


def global_mesh(model_parallel: int | None = None):
    """("data", "model") mesh over every rank of the job."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(n_devices=n, model_parallel=model_parallel)


# ---------------------------------------------------------------------------
# Ranks on one host
# ---------------------------------------------------------------------------


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        subs = [_to_cpu(v) for v in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*subs)
        return type(tree)(subs)
    return tree


def _rank_main(fn, rank, devices, store, out_dir, args, timeout):
    """A spawned rank: join the job, run fn(*args), save its result (on
    the CPU) or its traceback under ``out_dir``."""
    try:
        dev = devices[rank]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:  # the host's cores shared among the CPU ranks: idle OpenMP threads spin
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // len(devices)))
        dist.init_process_group(
            backend_for(devices), init_method=store, world_size=len(devices), rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        _JOB["devices"] = devices
        out = fn(*args)
        torch.save(_to_cpu(out), os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def spawn_ranks(fn, devices, args=(), *, timeout: float | None = 600.0, store_dir=None) -> list:
    """Run ``fn(*args)`` in one new process per entry of ``devices`` (the
    ``spawn`` start method), joined in one job through a ``file://``
    store in a temporary directory under ``store_dir``; returns each
    rank's result, in rank order, its tensors on the CPU.  ``fn`` must be
    importable by name (a module-level function).

    A rank that fails, or any rank still running ``timeout`` seconds
    after the start (None: no limit), stops every rank and raises
    ``RuntimeError`` with the failing ranks' tracebacks: no rank is passed
    over.  A collective waits at most ``timeout`` (or
    ``COLLECTIVE_TIMEOUT_S``) seconds for its peers."""
    import multiprocessing as mp

    devices = [torch.device(d) for d in devices]
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        store = f"file://{os.path.join(tmp, 'store')}"
        wait = COLLECTIVE_TIMEOUT_S if timeout is None else timeout
        procs = [ctx.Process(target=_rank_main, args=(fn, r, devices, store, tmp, args, wait))
                 for r in range(len(devices))]
        for p in procs:
            p.start()
        deadline = float("inf") if timeout is None else time.monotonic() + timeout
        failed = []
        try:
            while True:
                codes = [p.exitcode for p in procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed or all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    late = [r for r, c in enumerate(codes) if c is None]
                    raise RuntimeError(f"rank(s) {late} of {len(procs)} still running after "
                                       f"{timeout} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.kill()
                p.join()
        if failed:
            msgs = []
            for r in range(len(procs)):
                err = os.path.join(tmp, f"rank{r}.err")
                if os.path.exists(err):
                    with open(err) as f:
                        msgs.append(f"rank {r}:\n{f.read()}")
            raise RuntimeError(f"rank(s) {failed} of {len(procs)} failed (exit codes "
                               f"{[p.exitcode for p in procs]}):\n" + "\n".join(msgs))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(len(procs))]
