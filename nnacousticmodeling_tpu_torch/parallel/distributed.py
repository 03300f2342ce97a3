"""Multi-process bring-up helpers.

Counterpart of ``nnacousticmodeling_tpu/parallel/distributed.py``. JAX
runs one process per host over all of its devices; here every rank is a
process of its own. Each process calls ``initialize_distributed`` before
any device use, then builds its mesh over the world:

    # on every rank (or: torchrun ... -m ...train_cli --distributed)
    initialize_distributed("host0:29500", num_processes, process_id)
    mesh = pod_mesh({"fold": K, "data": world // K})

Backend: ``nccl`` when every rank has a card of its own (the ranks of
this node, ``LOCAL_WORLD_SIZE`` as ``torchrun`` sets it or else the
whole world, fit its ``torch.cuda.device_count()``, and the ranks run on
CUDA), ``gloo`` otherwise. One card with several ranks is a gloo world:
NCCL refuses two ranks on one GPU ("Duplicate GPU detected"). Gloo takes
CUDA tensors for the collectives the port uses, so the tensors stay on
the card; only the pipeline's point-to-point hops are staged through
host memory (``parallel/comm.py``).
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh

TIMEOUT_S = 60.0
# how long ranks wait while rank 0 alone runs a host phase of the master
# pipeline (fold generation, predictions, evaluation)
HOST_PHASE_TIMEOUT_S = 3600.0


def _pick_backend(world: int, device: str) -> str:
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if (torch.device(device).type == "cuda" and torch.cuda.is_available()
            and local <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
) -> str:
    """``init_process_group`` on ``tcp://{coordinator_address}`` with the
    given world size and rank, or on ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets them)
    when no coordinator is given. Call once per rank before any device
    use. A rank that does not arrive within ``TIMEOUT_S`` fails the run
    instead of hanging it. Returns (and prints) the backend picked for
    the ranks' ``device`` (see the module docstring)."""
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs --num-processes and "
                             "--process-id")
        init = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    else:
        init = "env://"
        world = int(num_processes if num_processes is not None
                    else os.environ.get("WORLD_SIZE", 1))
        rank = int(process_id if process_id is not None
                   else os.environ.get("RANK", 0))
    backend = _pick_backend(world, device)
    kwargs = {}
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        kwargs["device_id"] = torch.device(
            "cuda", local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, timeout=timedelta(seconds=TIMEOUT_S),
                            **kwargs)
    print(f"initialize_distributed: rank {rank} of {world}, backend "
          f"{backend}", flush=True)
    return backend


def rank_device(device: str = "cuda") -> torch.device:
    """This rank's device: ``cuda`` means ``cuda:{LOCAL_RANK %
    device_count}`` (several ranks of one card share it); anything else
    as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local % max(torch.cuda.device_count(), 1))
    return dev


def pod_mesh(axes: Dict[str, int], device=None) -> Mesh:
    """Mesh over every rank of the world."""
    return make_mesh(axes, device=device)


def local_batch_slice(global_batch: int) -> slice:
    """The rows of a globally-sharded batch this rank should feed (equal
    sharding over the world's ranks)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    per = global_batch // world
    return slice(rank * per, (rank + 1) * per)


def _placements(mesh: Mesh, axis_name: Optional[str]):
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(0) if name == axis_name else Replicate()
            for name in mesh.axis_names]


def global_batch_array(mesh: Mesh, local_rows: torch.Tensor,
                       axis_name: str = "data"):
    """A global batch from this rank's rows (those ``local_batch_slice``
    names): a ``DTensor`` sharded by rows over ``axis_name``, the
    counterpart of a sharded ``jax.Array``. No rank holds the global
    batch. On a one-rank mesh the rows themselves."""
    if mesh.device_mesh is None:
        return local_rows
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local_rows, mesh.device_mesh,
                              _placements(mesh, axis_name))


def replicated_array(mesh: Mesh, value: torch.Tensor):
    """A replicated ``DTensor`` from identical per-rank data (every rank
    must pass the same ``value``)."""
    if mesh.device_mesh is None:
        return value
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(value, mesh.device_mesh,
                              _placements(mesh, None))


def host_phase_barrier():
    """``(host, wait)``: whether this rank runs the phases only one rank
    may run (rank 0, or the only process), and a barrier the others wait
    at meanwhile. The barrier is on a gloo group of its own whose timeout
    (HOST_PHASE_TIMEOUT_S) bounds such a phase, not the training
    collectives' TIMEOUT_S; without a world it is a no-op."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return True, lambda: None
    group = dist.new_group(backend="gloo",
                           timeout=timedelta(seconds=HOST_PHASE_TIMEOUT_S))
    return dist.get_rank() == 0, lambda: dist.barrier(group=group)


def sync(name: str = "sync") -> None:
    """Barrier across all ranks (a bring-up aid); ``name`` is for the
    caller's logs."""
    if dist.is_initialized():
        dist.barrier()
