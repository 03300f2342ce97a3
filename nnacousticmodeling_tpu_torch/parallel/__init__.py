"""Data, tensor, fold and pipeline parallelism on ``torch.distributed``
(counterpart of ``nnacousticmodeling_tpu/parallel``): one process per
rank in the place of the devices of one JAX mesh."""

from .mesh import (
    make_mesh, parse_mesh_spec, replicate, shard_rows, param_shardings,
    make_sharded_train_step, make_sharded_ensemble_forward,
)
from .distributed import (
    initialize_distributed, pod_mesh, local_batch_slice,
    global_batch_array, replicated_array, sync,
)

__all__ = [
    "make_mesh",
    "parse_mesh_spec",
    "replicate",
    "shard_rows",
    "param_shardings",
    "make_sharded_train_step",
    "make_sharded_ensemble_forward",
    "initialize_distributed",
    "pod_mesh",
    "local_batch_slice",
    "global_batch_array",
    "replicated_array",
    "sync",
]
