"""Collectives over one axis of a rank mesh, and the point-to-point hops
of the pipeline.

An axis of size 1 needs no process group: its collectives are the
identity, as a one-device JAX mesh needs no communication.

Backends: ``gloo`` takes CUDA tensors for ``all_reduce``, ``all_gather``
and ``broadcast`` (measured on an H100 with two ranks on the card), so
those stay on the device. Its ``send`` / ``recv`` hand the device
pointer to the TCP transport, which fails ("writev ... Bad address").
``send`` and ``recv`` here therefore stage a CUDA tensor through a
pinned host buffer when the group's backend is gloo; ``nccl`` sends from
the device. Every multi-rank run on one card is a gloo run (NCCL refuses
two ranks on one GPU), so its pipeline hops take the host path.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def _host_staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, mesh, axis: str,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``axis``; returns ``t``."""
    if mesh.size(axis) > 1:
        dist.all_reduce(t, op=op, group=mesh.group(axis))
    return t


def all_gather_cat(t: torch.Tensor, mesh, axis: str, dim: int = 0
                   ) -> torch.Tensor:
    """Every rank's ``t`` of ``axis``, concatenated along ``dim`` in
    coordinate order."""
    n = mesh.size(axis)
    if n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=mesh.group(axis))
    return torch.cat(parts, dim)


def broadcast_(t: torch.Tensor, mesh, axis: str, src: int = 0
               ) -> torch.Tensor:
    """In-place broadcast of ``t`` from coordinate ``src`` of ``axis``."""
    if mesh.size(axis) > 1:
        group = mesh.group(axis)
        dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
    return t


def send(t: torch.Tensor, mesh, axis: str, dst: int) -> None:
    """Send ``t`` to coordinate ``dst`` of ``axis`` (host-staged for a
    CUDA tensor on gloo)."""
    group = mesh.group(axis)
    peer = dist.get_global_rank(group, dst)
    if _host_staged(t, group):
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
        t = buf
    dist.send(t.contiguous(), dst=peer, group=group)


def recv(like: torch.Tensor, mesh, axis: str, src: int,
         shape: Optional[torch.Size] = None) -> torch.Tensor:
    """A tensor of ``like``'s dtype and device (and ``shape``, default
    ``like``'s) received from coordinate ``src`` of ``axis``."""
    group = mesh.group(axis)
    peer = dist.get_global_rank(group, src)
    shape = like.shape if shape is None else shape
    if _host_staged(like, group):
        buf = torch.empty(shape, dtype=like.dtype, pin_memory=True)
        dist.recv(buf, src=peer, group=group)
        return buf.to(like.device)
    out = torch.empty(shape, dtype=like.dtype, device=like.device)
    dist.recv(out, src=peer, group=group)
    return out
