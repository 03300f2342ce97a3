"""Acoustic model stacks as ``nn.Module``s.

Counterpart of ``nnacousticmodeling_tpu/models/networks.py``. This slice
ports the LSTM stack (``networks.py:172-328``): each layer hoists its
input projection over all timesteps into one ``(B*T, D) @ (D, 4H)``
matmul, and only the recurrence runs per step, either as the float32
step loop (``scan_impl="xla"``, the twin of the JAX ``lax.scan`` path)
or through the CUDA recurrence kernels (``scan_impl="pallas"``, the twin
of the JAX Pallas path: ``ops.rnn_cuda.lstm_scan`` for inference and the
differentiable ``lstm_scan_train`` when training, as
``networks.py:268-271`` picks ``lstm_scan_pallas_train``; the CUDA
kernels for CUDA tensors, their plain bf16-operand versions for CPU
tensors).

Dropout is the JAX package's placement (``networks.py:42-47``, the
reference's): inverted dropout ``x / (1 - rate)`` on the input and after
every layer, only when training, its masks drawn from the
``torch.Generator`` the caller passes.

Parameter names follow the JAX pytree paths with ``.`` for ``/``
(``cells.0.wx``, ``out.w``), so ``train.checkpoint.load_jax_params``
output loads with ``load_state_dict``. Weights keep the dense
``(in, out)`` layout; nothing is transposed.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.rnn_cuda import lstm_scan, lstm_scan_train
from ..utils.device import resolve_device
from . import cells


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout, Chainer-compatible scaling (kept values are
    ``x / (1 - rate)``); the identity unless training with a generator
    and a rate above 0."""
    if not train or rate == 0.0 or generator is None:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < (
        1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), 0.0)


class _Dense(nn.Module):
    def __init__(self, params):
        super().__init__()
        self.w = nn.Parameter(params["w"])
        self.b = nn.Parameter(params["b"])


class _LSTMLayer(nn.Module):
    def __init__(self, params):
        super().__init__()
        self.wx = nn.Parameter(params["wx"])
        self.wh = nn.Parameter(params["wh"])
        self.b = nn.Parameter(params["b"])


class LSTM(nn.Module):
    """LSTM stack twin (chainer_networks.py:44-62).

    ``in_dim`` is the feature width (the JAX ``init``'s argument).
    Weights are drawn from ``seed`` with a ``torch.Generator`` (they do
    not equal the JAX init; load shared weights for parity).
    """

    is_recurrent = True

    def __init__(self, units: int, num_classes: int, layers: int = 2,
                 dropout: float = 0.0, *, in_dim: int,
                 scan_impl: str = "xla", device="cuda", seed: int = 0):
        super().__init__()
        if scan_impl not in ("xla", "pallas"):
            raise ValueError(f"scan_impl must be 'xla' or 'pallas', got "
                             f"{scan_impl!r}")
        dev = resolve_device(device)
        self.units, self.num_classes, self.layers = units, num_classes, layers
        self.dropout = dropout          # input and after every layer
        self.scan_impl = scan_impl
        gen = torch.Generator().manual_seed(seed)
        layer_list = []
        d = in_dim
        for _ in range(layers):
            layer_list.append(_LSTMLayer(cells.lstm_init(d, units, gen)))
            d = units
        self.cells = nn.ModuleList(layer_list)
        self.out = _Dense(cells.dense_init(d, num_classes, gen))
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.out.w.device

    def init_state(self, batch: int):
        return [cells.lstm_init_state(batch, self.units, device=self.device)
                for _ in range(self.layers)]

    def _params(self, l: int):
        layer = self.cells[l]
        return {"wx": layer.wx, "wh": layer.wh, "b": layer.b}

    def step(self, state, x: torch.Tensor):
        """One timestep (B, D) -> (new_state, (B, C) logits), float32."""
        new_state = []
        for l in range(self.layers):
            p = self._params(l)
            carry, x = cells.lstm_step(p, state[l], cells.lstm_input_proj(p, x))
            new_state.append(carry)
        return new_state, cells.dense({"w": self.out.w, "b": self.out.b}, x)

    def hidden_sequence(self, xs: torch.Tensor, state=None,
                        train: bool = False,
                        generator: Optional[torch.Generator] = None):
        """(B, T, D) -> ((B, T, H) last-layer hiddens, state).

        ``train`` turns dropout on (masks from ``generator``) and, with
        ``scan_impl="pallas"``, routes the recurrence through the
        differentiable ``lstm_scan_train``."""
        b, t, _ = xs.shape
        if state is None:
            state = self.init_state(b)
        xs = dropout(xs, self.dropout, train, generator)
        new_state = []
        for l in range(self.layers):
            p = self._params(l)
            proj = cells.lstm_input_proj(p, xs.reshape(b * t, -1))
            proj = proj.reshape(b, t, -1).transpose(0, 1).contiguous()
            if self.scan_impl == "pallas":
                c, h = state[l]
                scan = lstm_scan_train if train else lstm_scan
                carry, hs = scan(proj, p["wh"], c, h)
            else:
                carry = state[l]
                steps = []
                for k in range(t):
                    carry, h = cells.lstm_step(p, carry, proj[k])
                    steps.append(h)
                hs = torch.stack(steps)
            new_state.append(carry)
            xs = dropout(hs.transpose(0, 1), self.dropout, train,
                         generator)                       # (B, T, H)
        return xs, new_state

    def apply_sequence(self, xs: torch.Tensor, state=None,
                       train: bool = False,
                       generator: Optional[torch.Generator] = None):
        """(B, T, D) -> ((B, T, C) logits, state)."""
        b, t, _ = xs.shape
        hs, new_state = self.hidden_sequence(xs, state, train, generator)
        logits = cells.dense({"w": self.out.w, "b": self.out.b},
                             hs.reshape(b * t, -1))
        return logits.reshape(b, t, -1), new_state

    forward = apply_sequence


_LATER = {"ff", "tdnn", "zoneoutlstm", "zoneoutdropoutlstm", "peepholelstm",
          "gru", "mgrurelu", "mgrurelur"}


def get_network(network: str, layers: int, units: Sequence[int],
                num_classes: int, activation: str = "relu",
                tdnn_ksize: Sequence[int] = (5,),
                dropout: Sequence[float] = (0.0,), *, in_dim: int,
                scan_impl: str = "xla", device="cuda", seed: int = 0):
    """Twin of get_nn (chainer_networks.py:163-187). This slice builds
    ``"lstm"``; the rest of the zoo is ROADMAP Queue 1 item 8 (and MLP /
    TDNN item 2)."""
    dropout = (list(dropout) if not isinstance(dropout, (int, float))
               else [dropout])
    if network == "lstm":
        return LSTM(units=units[0], num_classes=num_classes, layers=layers,
                    dropout=dropout[0], in_dim=in_dim, scan_impl=scan_impl,
                    device=device, seed=seed)
    if network in _LATER:
        raise NotImplementedError(
            f"network {network!r} is not ported yet (ROADMAP Queue 1: "
            f"MLP/TDNN item 2, the recurrent zoo item 8)")
    raise ValueError(f"unknown network type: {network}")


def is_recurrent(network: str) -> bool:
    """Name-based predicate, twin of is_nn_recurrent
    (chainer_networks.py:186-187)."""
    return (network.endswith("lstm") or network.startswith("gru")
            or network.startswith("mgru"))
