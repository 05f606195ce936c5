"""Multi-GPU parallelism over torch.distributed; counterpart of
``vargp_tpu/parallel``.

Design, as in the JAX package: a 2-D ("data", "model") mesh.  The ELBO's
NLL is a sum over the batch, so the batch is data-parallel over "data";
every class's M x M system is independent, so the class axis (out_size)
shards over "model", and the only traffic across classes is the gather
of the function samples' moments at the softmax.  Gradients are summed
explicitly: a class-sharded leaf's over "data", a replicated leaf's over
every rank.

The port runs one process per rank: ``distributed.initialize`` joins a
multi-process job (the CLI's ``--coordinator_address``,
``--num_processes``, ``--process_id``), ``spawn_ranks`` starts local
ranks (the drivers' ``n_devices``), ``make_mesh`` builds the mesh.  Each
rank calls the kernels' operators on its own shard, so they run on
shard-local blocks by construction: the JAX package's partitioning rules
(``vargp_tpu/ops/partition.py``) have no counterpart to port.
"""

from vargp_tpu_torch.parallel.distributed import global_mesh, initialize, spawn_ranks
from vargp_tpu_torch.parallel.mesh import (
    Mesh,
    batch_shardings,
    infer_param_shardings,
    make_mesh,
    replicate,
    shard_batch,
    shard_params,
    unshard_to_host,
)
from vargp_tpu_torch.parallel.train_step import (
    make_sharded_device_train_fn,
    make_sharded_predict_fn,
    make_sharded_update_fn,
)

__all__ = [
    "make_mesh",
    "infer_param_shardings",
    "batch_shardings",
    "shard_params",
    "shard_batch",
    "replicate",
    "unshard_to_host",
    "make_sharded_update_fn",
    "make_sharded_device_train_fn",
    "make_sharded_predict_fn",
    "Mesh",
    "initialize",
    "global_mesh",
    "spawn_ranks",
]
