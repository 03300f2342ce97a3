"""Pipeline parallelism for deep feed-forward stacks.

Counterpart of ``nnacousticmodeling_tpu/parallel/pipeline.py``: the MLP's
hidden layers split into ``S = mesh stage-axis size`` contiguous groups
and microbatches stream through the stages GPipe-style. Stage 0 owns the
input layer; layers ``1..`` split near-evenly over the stages, and each
stage's rank holds only its own layers' weights (the last stage also the
output layer). The JAX version runs every stage every tick of a
``num_micro + S - 1``-tick scan under ``shard_map``; here each stage's
rank runs its microbatches in order, receiving each one's activations
from stage s-1 and sending its own to stage s+1 (``dist.send`` /
``dist.recv``, host-staged on gloo, ``parallel/comm.py``), so the same
``num_micro + S - 1`` steps of the GPipe schedule emerge from the
blocking hops. The last stage's logits are broadcast so that every rank
returns the full (N, C) output.

The hops are ``torch.autograd.Function``s whose backward sends the
gradient the other way, chained through one token per rank so each
rank's backward runs its hops in the reverse order of its forward (no
deadlock). A loss computed on the returned logits therefore
back-propagates through the stages: each rank's grads of its own layers
equal the single-process MLP's (the loss is taken to be the same on every
rank, so only the last stage's gradient of the logits is used).

Restrictions (raised, as in JAX): an MLP of uniform hidden width,
``layers >= S``, batch divisible by ``num_micro``, no train-time dropout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ..models.networks import MLP
from ..ops.rnn_cuda import ACTIVATIONS
from .comm import broadcast_, recv, send
from .mesh import Mesh


def _stage_bounds(n_layers: int, n_stages: int):
    """Near-even contiguous split of ``n_layers`` over ``n_stages``."""
    base, extra = divmod(n_layers, n_stages)
    sizes = [base + (1 if s < extra else 0) for s in range(n_stages)]
    bounds = np.cumsum([0] + sizes)
    return bounds, max(sizes)


class _Recv(torch.autograd.Function):
    """Forward: the activations of stage s-1. Backward: their gradient
    sent back to it."""

    @staticmethod
    def forward(ctx, token, like, mesh, axis, src):
        ctx.mesh, ctx.axis, ctx.src = mesh, axis, src
        return recv(like, mesh, axis, src), token.clone()

    @staticmethod
    def backward(ctx, g_h, g_token):
        send(g_h, ctx.mesh, ctx.axis, ctx.src)
        return g_token, None, None, None, None


class _Send(torch.autograd.Function):
    """Forward: ``h`` sent to stage s+1. Backward: its gradient received
    from there."""

    @staticmethod
    def forward(ctx, h, token, mesh, axis, dst):
        ctx.mesh, ctx.axis, ctx.dst = mesh, axis, dst
        ctx.like = torch.empty_like(h)
        send(h, mesh, axis, dst)
        return token.clone()

    @staticmethod
    def backward(ctx, g_token):
        g_h = recv(ctx.like, ctx.mesh, ctx.axis, ctx.dst)
        return g_h, g_token, None, None, None


class _BroadcastLast(torch.autograd.Function):
    """Forward: the last stage's logits on every rank. Backward: the last
    stage keeps its own gradient of them; the other ranks' only carries
    their token chain into their hops."""

    @staticmethod
    def forward(ctx, logits, token, mesh, axis, last):
        ctx.is_last = mesh.rank(axis) == last
        out = logits.clone()
        broadcast_(out, mesh, axis, last)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.is_last:
            return g, None, None, None, None
        return None, torch.zeros((), device=g.device), None, None, None


@dataclass(frozen=True)
class PipelinedMLP:
    """GPipe-style pipelined twin of an ``MLP`` over a mesh stage axis.

    ``apply(params, x)`` reads the ORIGINAL MLP params (the net's
    state-dict names; each stage takes only its own layers) and equals
    ``net.apply`` with those params for dropout-free forward passes."""

    net: MLP
    mesh: Mesh
    num_micro: int = 4
    stage_axis: str = "stage"

    @property
    def num_stages(self) -> int:
        return self.mesh.size(self.stage_axis)

    def stage_layers(self, stage: int):
        """The hidden-layer indices stage ``stage`` runs (stage 0 also the
        input layer 0)."""
        bounds, _ = _stage_bounds(self.net.layers - 1, self.num_stages)
        own = [l + 1 for l in range(bounds[stage], bounds[stage + 1])]
        return ([0] if stage == 0 else []) + own

    def apply(self, params: Dict[str, torch.Tensor], x: torch.Tensor,
              generator=None, train: bool = False) -> torch.Tensor:
        """(N, D) -> (N, C) logits, equal to ``self.net.apply``.

        Dropout is unsupported here (``train`` must stay off for a net
        with dropout): per-layer mask draws would need a per-stage
        generator protocol."""
        net, S, M = self.net, self.num_stages, self.num_micro
        if train and net.dropout:
            raise NotImplementedError("pipelined dropout not supported")
        if net.layers < S:
            raise ValueError(f"{net.layers} layers < {S} stages")
        N = x.shape[0]
        if N % M:
            raise ValueError(f"batch {N} not divisible by {M} microbatches")
        mb = N // M
        act = ACTIVATIONS[net.activation]
        mesh, axis = self.mesh, self.stage_axis
        s, last = mesh.rank(axis), S - 1
        layers = [(params[f"hidden.{l}.w"], params[f"hidden.{l}.b"])
                  for l in self.stage_layers(s)]
        wo, bo = params["out.w"], params["out.b"]
        C, U = wo.shape[1], net.units
        like = x.new_empty((mb, U))
        token = torch.zeros((), device=x.device, requires_grad=True)
        outs = []
        for m in range(M):
            if s == 0:
                h = x[m * mb:(m + 1) * mb]
            else:
                h, token = _Recv.apply(token, like, mesh, axis, s - 1)
            for w, b in layers:
                h = act(h @ w + b)
            if s < last:
                token = _Send.apply(h, token, mesh, axis, s + 1)
            else:
                outs.append(h @ wo + bo)
        logits = (torch.cat(outs) if s == last
                  else x.new_zeros((N, C)))
        return _BroadcastLast.apply(logits, token, mesh, axis, last)
