"""Rank mesh and sharding helpers on ``torch.distributed``.

Counterpart of ``nnacousticmodeling_tpu/parallel/mesh.py``. A JAX mesh is
a grid of devices driven by one program; here it is a grid of ranks, one
process each, over the default process group, axes in dict order and
ranks laid out rank-major (``np.reshape`` of ``range(world)``). Each
axis has its own process group. A mesh whose axes multiply to 1 needs no
process group, and its collectives are the identity.

Axes (as in JAX):

* ``data``  -- the minibatch rows split over ranks; gradients all-reduced
  and divided by the axis size before every optimizer step;
* ``model`` -- tensor parallelism: the dense and convolution layers'
  weights column-parallel over their output dimension (Megatron-style
  products, ``ColumnParallelDense`` / ``ColumnParallelConv``);
* ``fold``  -- k-fold ensemble parallelism: each fold rank holds K/f of
  the fold nets (``make_sharded_ensemble_forward``,
  ``train.fold_parallel``).

One deliberate difference from the JAX sharding rule: the recurrent
cells' leaves stay replicated over ``model``. The persistent recurrence
kernels hold one whole ``W_h`` (and the peephole weights) on chip
(``ops/rnn_cuda.py``), so those leaves cannot be split; the hoisted
input projection ``wx`` / ``b`` of a cell is kept whole beside them.
The JAX docstring itself notes that correctness never depends on the
sharding choice.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..models.networks import _Conv, _Dense
from .comm import all_gather_cat, all_reduce_, broadcast_

Spec = Tuple[Optional[str], ...]


class Mesh:
    """A grid of ranks: ``axis_names``, ``shape``, this rank's coordinate
    on each axis, one process group per axis (None on a one-rank mesh)
    and the ``DeviceMesh`` it was built on (None on a one-rank mesh)."""

    def __init__(self, axes: Dict[str, int], device_mesh=None):
        self.axis_names = tuple(axes)
        self.shape = tuple(int(v) for v in axes.values())
        self.device_mesh = device_mesh
        if device_mesh is None:
            self.coords = {name: 0 for name in self.axis_names}
            self.groups = {name: None for name in self.axis_names}
        else:
            self.coords = dict(zip(self.axis_names,
                                   device_mesh.get_coordinate()))
            self.groups = {name: device_mesh.get_group(name)
                           for name in self.axis_names}

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def size(self, axis: str) -> int:
        return self.axis_sizes[axis]

    def rank(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """Rank 0 of the world (or no world): the one rank that writes
    artifacts."""
    return not dist.is_initialized() or dist.get_rank() == 0


def check_world(axes: Dict[str, int]) -> int:
    """The rank count ``axes`` needs; it must be the world size."""
    n = math.prod(int(v) for v in axes.values())
    have = world_size()
    if n != have:
        raise ValueError(f"need {n} ranks, have {have}")
    return n


def make_mesh(axes: Dict[str, int], device=None) -> Mesh:
    """Mesh over the ranks of the default process group, axes in dict
    order. ``prod(axes)`` must equal the world size (1 without a process
    group). ``device``: where the ranks' tensors live (default ``cuda``
    when a card is present), the ``DeviceMesh``'s device type."""
    n = check_world(axes)
    shape = tuple(int(v) for v in axes.values())
    if n == 1:
        return Mesh(axes)
    from torch.distributed.device_mesh import init_device_mesh
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return Mesh(axes, init_device_mesh(torch.device(device).type, shape,
                                       mesh_dim_names=tuple(axes)))


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """Parse a ``--mesh`` CLI value like ``"data=4,model=2"`` or
    ``"fold=2,data=4"`` into an ordered axis dict."""
    axes: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad mesh axis {part!r}; expected name=size")
        name, size = part.split("=", 1)
        axes[name.strip()] = int(size)
    if not axes:
        raise ValueError(f"empty mesh spec {spec!r}")
    return axes


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree) if torch.is_tensor(tree) else tree


def replicate(mesh: Mesh, tree):
    """Every tensor leaf of ``tree`` as rank 0 holds it (a broadcast from
    rank 0 of each leaf; the tree itself without a process group)."""
    if not dist.is_initialized():
        return tree

    def bcast(t):
        t = t.detach().clone()
        dist.broadcast(t, src=0)
        return t
    return _tree_map(bcast, tree)


def shard_rows(mesh: Mesh, t: torch.Tensor, axis_name: str = "data"
               ) -> torch.Tensor:
    """This rank's rows of ``t`` (dim 0 split evenly over ``axis_name``)."""
    n, r = mesh.size(axis_name), mesh.rank(axis_name)
    if t.shape[0] % n:
        raise ValueError(f"{t.shape[0]} rows not divisible by {axis_name!r} "
                         f"size {n}")
    per = t.shape[0] // n
    return t[r * per:(r + 1) * per]


def _kernel_read(name: str) -> bool:
    """A leaf of a recurrent cell (``cells.<l>.*``, also under a CTC
    model's ``fwd.`` / ``bwd.``): read whole by the recurrence kernels."""
    return "cells" in name.split(".")


def param_shardings(mesh: Mesh, params, model_axis: Optional[str] = None
                    ) -> Dict[str, Spec]:
    """name -> partition spec (a tuple, as ``tuple(PartitionSpec)``):
    ``()`` replicated, ``(None, ..., model_axis)`` column-parallel over
    the last dim.

    Without a model axis everything is replicated. With one, every leaf
    whose last dim divides the axis size is column-parallel (the JAX
    rule), except the recurrent cells' leaves (see the module
    docstring)."""
    if model_axis is None:
        return {name: () for name in params}
    m = mesh.size(model_axis)
    out = {}
    for name, leaf in params.items():
        if (leaf.dim() >= 1 and leaf.shape[-1] % m == 0
                and leaf.shape[-1] >= m and not _kernel_read(name)):
            out[name] = (None,) * (leaf.dim() - 1) + (model_axis,)
        else:
            out[name] = ()
    return out


# ---------------------------------------------------------------------------
# column-parallel products (tensor parallelism over ``model``)
# ---------------------------------------------------------------------------

class _CopyToAxis(torch.autograd.Function):
    """The identity forward; the input gradient all-reduced over the
    axis backward (each rank's columns contribute their part of it)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.mesh, ctx.axis), None, None


class _GatherFromAxis(torch.autograd.Function):
    """Every rank's columns gathered along ``dim`` forward; this rank's
    columns of the gradient backward. Every rank of the axis computes the
    same loss on the gathered output, so the gradient is not summed over
    the axis (``torch.distributed.nn``'s all_gather would reduce-scatter
    it and multiply it by the axis size)."""

    @staticmethod
    def forward(ctx, y, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather_cat(y, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.mesh, ctx.axis
        part = g.chunk(mesh.size(axis), ctx.dim)[mesh.rank(axis)]
        return part.contiguous(), None, None, None


class ColumnParallelDense(nn.Module):
    """A dense layer holding this rank's columns of ``w`` / ``b``; its
    output is the full ``x @ w + b`` on every rank of the axis."""

    def __init__(self, w, b, mesh: Mesh, axis: str):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)
        self.mesh, self.axis = mesh, axis

    def forward(self, x):
        y = _CopyToAxis.apply(x, self.mesh, self.axis) @ self.w + self.b
        return _GatherFromAxis.apply(y, self.mesh, self.axis, -1)


class ColumnParallelConv(ColumnParallelDense):
    """A TDNN convolution holding this rank's output channels."""

    def forward(self, x):
        x = _CopyToAxis.apply(x, self.mesh, self.axis)
        y = F.conv1d(x, self.w.permute(2, 1, 0)) + self.b[:, None]
        return _GatherFromAxis.apply(y, self.mesh, self.axis, 1)


_PARALLEL_OF = {_Dense: ColumnParallelDense, _Conv: ColumnParallelConv}
_PLAIN_OF = {ColumnParallelDense: _Dense, ColumnParallelConv: _Conv}


def _set_submodule(net: nn.Module, name: str, module: nn.Module) -> None:
    parent, _, leaf = name.rpartition(".")
    setattr(net.get_submodule(parent) if parent else net, leaf, module)


def shard_net(net: nn.Module, mesh: Mesh, model_axis: Optional[str]
              ) -> Dict[str, Spec]:
    """Make ``net``'s dense and convolution layers whose leaves
    ``param_shardings`` puts column-parallel hold this rank's columns
    (in place; the state-dict names stay). Returns the specs of the
    leaves it sharded (empty without a model axis of size > 1). Every
    other leaf, a recurrent cell's or a head's of another kind, stays
    replicated."""
    if model_axis is None or mesh.size(model_axis) == 1:
        return {}
    specs = param_shardings(mesh, net.state_dict(), model_axis)
    m, r = mesh.size(model_axis), mesh.rank(model_axis)
    sharded = {}
    for name, mod in list(net.named_modules()):
        cls = _PARALLEL_OF.get(type(mod))
        if cls is None or not specs.get(f"{name}.w") \
                or not specs.get(f"{name}.b"):
            continue
        cols = [p.detach().chunk(m, -1)[r].clone() for p in (mod.w, mod.b)]
        _set_submodule(net, name, cls(*cols, mesh, model_axis))
        for leaf in ("w", "b"):
            sharded[f"{name}.{leaf}"] = specs[f"{name}.{leaf}"]
    return sharded


def unshard_net(net: nn.Module) -> None:
    """Gather every column-parallel layer of ``net`` back into a whole
    layer (collective over its axis), in place."""
    for name, mod in list(net.named_modules()):
        cls = _PLAIN_OF.get(type(mod))
        if cls is None:
            continue
        full = {leaf: all_gather_cat(getattr(mod, leaf).detach(), mod.mesh,
                                     mod.axis, -1) for leaf in ("w", "b")}
        _set_submodule(net, name, cls(full))


def gather_leaves(params: Dict[str, torch.Tensor], sharded, mesh: Mesh,
                  model_axis: Optional[str]) -> Dict[str, torch.Tensor]:
    """``params`` with every leaf named in ``sharded`` gathered whole over
    ``model_axis`` (collective)."""
    return {n: all_gather_cat(v.detach(), mesh, model_axis, -1)
            if n in sharded else v for n, v in params.items()}


def local_leaves(params: Dict[str, torch.Tensor], sharded, mesh: Mesh,
                 model_axis: Optional[str]) -> Dict[str, torch.Tensor]:
    """``params`` (whole) with every leaf named in ``sharded`` cut to this
    rank's columns."""
    if not sharded:
        return dict(params)
    m, r = mesh.size(model_axis), mesh.rank(model_axis)
    return {n: v.chunk(m, -1)[r].contiguous() if n in sharded else v
            for n, v in params.items()}


def reduce_gradients(params: Iterable[torch.Tensor], mesh: Mesh,
                     data_axis: str) -> None:
    """Average the gradients of ``params`` over ``data_axis``: one
    all-reduce of the flattened gradients, divided by the axis size (a
    missing gradient counts as zeros)."""
    d = mesh.size(data_axis)
    if d == 1:
        return
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    all_reduce_(flat, mesh, data_axis)
    flat.div_(d)
    off = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[off:off + n].view_as(p.grad))
        off += n


class DataSplit:
    """The data axis of a run, the one home of its policy (the engine's
    mesh runs, the fold trainer and ``make_sharded_train_step`` all use
    it): each rank takes its rows of every batch, the gradients are
    all-reduced over the axis and divided by its size before every
    optimizer step, epoch metrics are averaged over it, and validation
    numbers are rank 0's on every rank (``agree``), so every rank
    decides alike and none deadlocks the next collective.

    ``axis`` None: a mesh without a data axis (every method is the
    identity). ``batch_sizes``: checked here to divide the axis size.
    ``agree_axes``: the axes whose ranks train the same nets (default
    every axis of the mesh)."""

    def __init__(self, mesh: Mesh, axis: Optional[str] = "data",
                 batch_sizes: Iterable[int] = (),
                 agree_axes: Optional[Iterable[str]] = None):
        if axis is not None and axis not in mesh.axis_sizes:
            raise ValueError(f"mesh has no {axis!r} axis")
        self.mesh, self.axis = mesh, axis
        self.d = mesh.size(axis) if axis is not None else 1
        self.r = mesh.rank(axis) if axis is not None else 0
        self.agree_axes = tuple(mesh.axis_names if agree_axes is None
                                else agree_axes)
        for bs in batch_sizes:
            self.check(bs)

    def check(self, rows: int) -> None:
        if rows % self.d:
            raise ValueError(f"batch size {rows} not divisible by "
                             f"data-axis size {self.d}")

    def rows(self, t, dim: int = 0) -> torch.Tensor:
        """This rank's rows of ``t`` along ``dim`` (a row-sharded
        DTensor's local shard)."""
        if hasattr(t, "to_local"):
            return t.to_local()
        if self.d == 1:
            return t
        self.check(t.shape[dim])
        per = t.shape[dim] // self.d
        return t.narrow(dim, self.r * per, per)

    def reduce(self, params: Iterable[torch.Tensor]) -> None:
        if self.d > 1:
            reduce_gradients(params, self.mesh, self.axis)

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        if self.d == 1:
            return t
        return all_reduce_(t.clone(), self.mesh, self.axis) / self.d

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of ``t``, in rank order."""
        if self.d == 1:
            return t
        return all_gather_cat(t, self.mesh, self.axis, 0)

    def agree(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as coordinate 0 of every agree axis holds it (in place)."""
        for axis in self.agree_axes:
            broadcast_(t, self.mesh, axis)
        return t


# ---------------------------------------------------------------------------
# the sharded train step and the fold-sharded ensemble forward
# ---------------------------------------------------------------------------

def make_sharded_train_step(net, opt, mesh: Mesh, data_axis: str = "data",
                            model_axis: Optional[str] = None,
                            bprop_len: int = 20):
    """One data-parallel (+ optional column-parallel over ``model_axis``)
    training step of ``net``.

    ``opt``: the port's ``make_optimizer`` bound to a name and lr
    (``functools.partial(make_optimizer, "adam", 1e-3)``); it is called
    once on the sharded net's parameters. ``net``'s column-parallel
    layers are sharded in place.

    Feed-forward nets: ``step(params, opt_state, xb, yb, rng)``.
    Recurrent nets: ``step(params, opt_state, state, xb, yb, rng)`` with
    xb (B, L, D), the TBPTT chunk. ``params`` (whole, state-dict names;
    None keeps the net's own), ``opt_state`` (an optimizer
    ``state_dict`` of this rank, None for a fresh one), ``state`` (the
    global B streams' state, or None) and the batch (full tensors or
    row-sharded DTensors) as the JAX step takes its global arrays; each
    rank takes its rows. ``rng``: the dropout ``torch.Generator`` or
    None. The loss is the batch mean (summed over L for recurrent nets);
    the gradients are all-reduced over ``data_axis`` and divided by its
    size before the optimizer steps. Returns (params, opt_state[,
    state], loss), params and state whole, loss the global batch's."""
    split = DataSplit(mesh, data_axis)
    recurrent = getattr(net, "is_recurrent", False)
    sharded = shard_net(net, mesh, model_axis)
    optimizer = opt(net.parameters())

    def begin(params, opt_state):
        if params is not None:
            net.load_state_dict(local_leaves(
                {k: torch.as_tensor(v) for k, v in params.items()}, sharded,
                mesh, model_axis))
        if opt_state is None:
            optimizer.state.clear()
        else:
            optimizer.load_state_dict(opt_state)

    def finish(loss):
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        split.reduce(net.parameters())
        optimizer.step()
        params = gather_leaves({k: v.detach().clone() for k, v in
                                net.state_dict().items()}, sharded, mesh,
                               model_axis)
        return params, optimizer.state_dict(), split.mean(loss.detach())

    if recurrent:
        def step(params, opt_state, state, xb, yb, rng=None):
            begin(params, opt_state)
            xb = split.rows(xb)
            yb = split.rows(yb).long()
            b, t = yb.shape
            if state is not None:
                state = [tuple(split.rows(a) for a in layer)
                         for layer in state]
            logits, new_state = net.apply_sequence(xb, state, train=True,
                                                   generator=rng)
            ce = F.cross_entropy(logits.reshape(b * t, -1), yb.reshape(-1),
                                 reduction="none").reshape(b, t)
            params, opt_state, loss = finish(ce.mean(dim=0).sum())
            new_state = [tuple(split.gather(a.detach()) for a in layer)
                         for layer in new_state]
            return params, opt_state, new_state, loss
        return step

    def step(params, opt_state, xb, yb, rng=None):
        begin(params, opt_state)
        xb = split.rows(xb)
        yb = split.rows(yb).long()
        logits = net.apply(xb, train=True, generator=rng)
        return finish(F.cross_entropy(logits, yb))
    return step


def make_sharded_ensemble_forward(ensemble, mesh: Mesh,
                                  fold_axis: str = "fold"):
    """Fold-parallel ensemble forward: ``shard_folds(stacked)`` keeps this
    fold rank's K/f rows of every stacked fold leaf; ``forward(params,
    xs)`` runs those fold nets as passes of the one module (each on the
    module's own route, as ``models.ensemble`` runs them), all-reduces
    their summed logits over ``fold_axis`` and returns the ensemble's
    combination (master and RPL head, where given) on every rank."""
    f, r = mesh.size(fold_axis), mesh.rank(fold_axis)
    net = ensemble.network

    def shard_folds(stacked_params):
        out = {}
        for name, leaf in stacked_params.items():
            if leaf.shape[0] % f:
                raise ValueError(f"{leaf.shape[0]} folds not divisible by "
                                 f"{fold_axis!r} size {f}")
            per = leaf.shape[0] // f
            out[name] = leaf[r * per:(r + 1) * per]
        return out

    def one(p, xs):
        if ensemble.is_recurrent:
            return functional_call(net, p, (xs, None))[0]
        return functional_call(net, p, (xs,))

    def forward(params, xs):
        folds = params.get("folds")
        master = params.get("master")
        h = one(dict(master), xs) if master is not None else None
        if folds is not None:
            n_local = next(iter(folds.values())).shape[0]
            total = None
            for k in range(n_local):
                y = one({n: v[k] for n, v in folds.items()}, xs)
                total = y if total is None else total + y
            total = all_reduce_(total.contiguous(), mesh, fold_axis)
            k_all = n_local * f
            h = (total / k_all if h is None
                 else (h * k_all + total) / (2 * k_all))
        return ensemble._head(params, h)

    return shard_folds, forward


__all__ = [
    "Mesh", "make_mesh", "parse_mesh_spec", "replicate", "shard_rows",
    "param_shardings", "make_sharded_train_step",
    "make_sharded_ensemble_forward", "shard_net", "unshard_net",
    "gather_leaves", "local_leaves", "reduce_gradients", "DataSplit",
    "is_primary",
    "world_size", "check_world",
]
