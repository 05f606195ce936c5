"""The ("data", "model") mesh of ranks and its sharding rules.

Counterpart of ``vargp_tpu/parallel/mesh.py``.  The port runs one process
per rank (SPMD with a controller per rank, not JAX's single controller):
each rank holds its own shard of every tensor, and the collectives
between them are explicit calls on the mesh's process groups.

Sharding policy, as in the JAX package:
  - class-batched GP state (z, u_mean, u_tril*, the frozen chain's
    entries and their optimizer moments): the first axis (out_size) over
    "model", each rank a contiguous slice of the classes;
  - kernel hyperparameters and the MLP feature map (phi): replicated;
  - data batches: the leading (batch) axis over "data".

``Mesh`` is a small class of its own rather than
``torch.distributed.device_mesh.DeviceMesh``: a ``DeviceMesh`` on "cuda"
binds rank r to card r, while several ranks share one card here (the
one-card machine, and every CPU test).

Each collective a rank takes part in is one ``all_reduce``, and is
recorded in ``Mesh.log`` as (what, axis, shape): the gather of the class
axis is an ``all_reduce`` of a zero-padded buffer (exact: every entry but
one of a sum is zero), which every backend supports on CUDA tensors.
"""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from vargp_tpu_torch.train.optim import tree_unflatten
from vargp_tpu_torch.utils.checkpoint import flatten_with_paths

AXES = ("data", "model")


class Mesh:
    """A (dp, mp) grid of ranks with axis names ("data", "model"); rank r
    sits at (r // mp, r % mp).  Holds this rank's coordinates and device,
    and the process groups of its data axis (the ranks of its model
    coordinate) and of its model axis (the ranks of its data coordinate).
    A group of one rank is None: its collectives are no-ops."""

    axis_names = AXES

    def __init__(self, shape: tuple, rank: int, device: torch.device, groups: dict):
        self.shape = tuple(shape)
        self.rank = rank
        self.coords = divmod(rank, self.shape[1])
        self.device = torch.device(device)
        self._groups = groups  # axis ("data", "model", "all") -> group or None
        self.log = []  # (what, axis, shape) of each collective, in order

    def __repr__(self):
        return (f"Mesh({self.shape[0]} data x {self.shape[1]} model, rank {self.rank} "
                f"at {self.coords} on {self.device})")

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    def axis_size(self, axis: str) -> int:
        return {"data": self.shape[0], "model": self.shape[1], "all": self.size}[axis]

    def class_slice(self, out_size: int) -> slice:
        """This rank's contiguous slice of ``out_size`` classes."""
        mp = self.shape[1]
        if out_size % mp:
            raise ValueError(f"out_size={out_size} is not divisible by model_parallel={mp}")
        n = out_size // mp
        return slice(self.coords[1] * n, (self.coords[1] + 1) * n)

    def row_slice(self, n_rows: int) -> slice:
        """This rank's contiguous slice of a batch of ``n_rows`` rows."""
        dp = self.shape[0]
        if n_rows % dp:
            raise ValueError(f"a batch of {n_rows} rows is not divisible by the {dp} data ranks")
        n = n_rows // dp
        return slice(self.coords[0] * n, (self.coords[0] + 1) * n)

    def local_cfg(self, cfg):
        """``cfg`` with out_size set to this rank's number of classes."""
        sl = self.class_slice(cfg.out_size)
        return dataclasses.replace(cfg, out_size=sl.stop - sl.start)

    def _all_reduce(self, t: torch.Tensor, axis: str, what: str) -> torch.Tensor:
        """Sum ``t`` in place over ``axis``'s group (no-op for one rank)."""
        group = self._groups[axis]
        if self.axis_size(axis) > 1:
            self.log.append((what, axis, tuple(t.shape)))
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    def all_sum(self, t: torch.Tensor, axis: str, what: str = "sum") -> torch.Tensor:
        """A new tensor: ``t`` summed over ``axis`` ("data", "model" or
        "all"), the same on every rank of the group; not differentiable."""
        return self._all_reduce(t.detach().clone(), axis, what)

    def gather_classes(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every class of the model axis along ``dim`` (this rank's slice
        at its place), differentiable: the backward sums the gradient over
        the model group, then keeps this rank's slice."""
        if self.shape[1] == 1:
            return t
        return _GatherClasses.apply(t, self, dim)

    def sum_gradients(self, grads: list, params, out_size: int) -> list:
        """The gradient leaves (in ``params``' leaf order) summed over the
        ranks that share them: a class-sharded leaf's over the data axis
        (its classes live on no other model rank), a replicated leaf's
        over every rank; one ``all_reduce`` of each kind's leaves,
        flattened together."""
        local = self.class_slice(out_size)
        sharded = [_is_class_batched(p, leaf, local.stop - local.start)
                   for p, leaf in flatten_with_paths(params)]
        out = list(grads)
        for flag, axis, what in ((True, "data", "sum class-sharded grads"),
                                 (False, "all", "sum replicated grads")):
            idx = [i for i, s in enumerate(sharded) if s == flag]
            if not idx or self.axis_size(axis) == 1:
                continue
            flat = self._all_reduce(torch.cat([grads[i].reshape(-1) for i in idx]), axis, what)
            for i, part in zip(idx, torch.split(flat, [grads[i].numel() for i in idx])):
                out[i] = part.view_as(grads[i])
        return out


class _GatherClasses(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, dim):
        n = t.shape[dim]
        shape = list(t.shape)
        shape[dim] = n * mesh.shape[1]
        buf = t.new_zeros(shape)
        buf.narrow(dim, mesh.coords[1] * n, n).copy_(t)
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, n
        return mesh._all_reduce(buf, "model", "gather f")

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = mesh._all_reduce(g.contiguous().clone(), "model", "gather f backward")
        return g.narrow(ctx.dim, mesh.coords[1] * ctx.n, ctx.n), None, None


def _new_groups(dp: int, mp: int) -> dict:
    """Every data and model group of a (dp, mp) grid, made on every rank
    in the same order (``new_group`` is collective over the job); returns
    this rank's."""
    rank = dist.get_rank()
    data = [dist.new_group([d * mp + m for d in range(dp)]) if dp > 1 else None
            for m in range(mp)]
    model = [dist.new_group([d * mp + m for m in range(mp)]) if mp > 1 else None
             for d in range(dp)]
    d, m = divmod(rank, mp)
    return {"data": data[m], "model": model[d], "all": None}


def make_mesh(n_devices: int | None = None, model_parallel: int | None = None,
              devices=None) -> Mesh:
    """2-D ("data", "model") mesh over the job's ranks.

    ``n_devices`` defaults to the job's world size (1 outside a process
    group) and may not differ from it: every rank of the job is in the
    mesh.  ``model_parallel`` defaults to 2 when the count is even and
    above 1, else 1.  ``devices`` lists one ``torch.device`` per rank
    (several ranks may share one card, or the CPU); by default the job's
    own (``distributed.job_devices``: rank r on card r)."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    n = int(n_devices or world)
    if n > world:
        raise ValueError(
            f"requested n_devices={n} but the job has only {world} rank(s); start {n} "
            "(the drivers' n_devices spawns them on one host; across hosts, "
            "parallel.distributed.initialize with the multi-process flags)")
    if n < world:
        raise ValueError(f"requested n_devices={n} in a job of {world} ranks: every rank "
                         "of the job is in the mesh")
    if devices is None:
        from vargp_tpu_torch.parallel.distributed import job_devices

        devices = job_devices(n)
    devices = [torch.device(d) for d in devices]
    if len(devices) < n:
        raise ValueError(f"requested n_devices={n} but only {len(devices)} device(s) are "
                         f"listed ({[str(d) for d in devices]})")
    if model_parallel is None:
        model_parallel = 2 if n % 2 == 0 and n > 1 else 1
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    dp, mp = n // model_parallel, model_parallel
    groups = _new_groups(dp, mp) if n > 1 else {"data": None, "model": None, "all": None}
    return Mesh((dp, mp), rank, devices[rank], groups)


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------


def _map(tree, fn):
    """``tree`` with each leaf replaced by fn(key path, leaf)."""
    return tree_unflatten(tree, [fn(path, leaf) for path, leaf in flatten_with_paths(tree)])


class PartitionSpec:
    """A leaf's placement, JAX's ``PartitionSpec``: one entry per axis,
    the mesh axis it is split over or None; () is replicated."""

    def __init__(self, *axes):
        self.axes = axes

    def __eq__(self, other):
        return isinstance(other, PartitionSpec) and self.axes == other.axes

    def __hash__(self):
        return hash(self.axes)

    def __repr__(self):
        return f"PartitionSpec{self.axes!r}"


def _is_class_batched(path_str: str, leaf, out_size: int) -> bool:
    if "kernel" in path_str or "phi" in path_str:
        return False
    return getattr(leaf, "ndim", 0) >= 1 and leaf.shape[0] == out_size


def infer_param_shardings(tree, mesh: Mesh, out_size: int):
    """Each leaf's ``PartitionSpec``, a tree of ``tree``'s structure:
    ("model", None, ...) for a class-batched leaf, () for a replicated
    one.  Optimizer states mirror their parameters' structure and follow
    the same rule."""
    def spec(path, leaf):
        if _is_class_batched(path, leaf, out_size):
            return PartitionSpec("model", *(None,) * (leaf.ndim - 1))
        return PartitionSpec()

    return _map(tree, spec)


def batch_shardings(mesh: Mesh):
    """(x, y, w) specs: the batch axis over "data"."""
    return PartitionSpec("data", None), PartitionSpec("data"), PartitionSpec("data")


def shard_params(tree, mesh: Mesh, out_size: int):
    """This rank's shard of a whole tree (every rank passes the same
    values): the class slice of each class-batched leaf, a copy of each
    other one, on the rank's device."""
    sl = mesh.class_slice(out_size)

    def put(path, leaf):
        if _is_class_batched(path, leaf, out_size):
            leaf = leaf[sl]
        return leaf.to(mesh.device).contiguous().clone()

    return _map(tree, put)


def shard_batch(x, y, w, mesh: Mesh):
    """This rank's rows of a whole batch."""
    rows = mesh.row_slice(x.shape[0])
    return tuple(t[rows].to(mesh.device) for t in (x, y, w))


def replicate(tree, mesh: Mesh):
    """Every leaf on the rank's device, whole."""
    return _map(tree, lambda _, leaf: leaf.to(mesh.device))


def unshard_to_host(tree, mesh: Mesh, out_size: int):
    """Identical numpy copies of the whole tree on every rank.

    A leaf is class-sharded when the sharding rule holds for it at this
    rank's class count (``out_size / model_parallel``); its slices are
    gathered over the model group.  COLLECTIVE: every rank of the mesh
    calls it (a lead-gated write comes after)."""
    local = mesh.class_slice(out_size)
    n_local = local.stop - local.start

    def fetch(path, leaf):
        if mesh.shape[1] > 1 and _is_class_batched(path, leaf, n_local):
            leaf = mesh.gather_classes(leaf.detach(), 0)
        return np.array(leaf.detach().cpu().numpy())

    with torch.no_grad():
        return _map(tree, fetch)
