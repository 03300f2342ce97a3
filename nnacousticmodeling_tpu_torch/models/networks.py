"""Acoustic model stacks as ``nn.Module``s.

Counterpart of ``nnacousticmodeling_tpu/models/networks.py``: every net
of the zoo. The feed-forward nets are the MLP (``networks.py:60-89``)
and the TDNN (``:92-165``): dense products and ``F.conv1d``, with no
kernel of their own (the JAX package has none for them either). The
recurrent nets are the LSTM stack (``networks.py:298-328``), the zoneout
LSTM stacks without and with dropout (``:331-372``), the peephole LSTM
stack (``:375-409``), the GRU stack (``:412-456``) and the minimal-GRU
stack with and without its reset gate (``MGRUNet``, ``:459-531``).
Each recurrent layer hoists its input projection over all timesteps into
one ``(B*T, D) @ (D, G*H)`` matmul, and only the recurrence runs per
step,
either as the float32 step loop (``scan_impl="xla"``, the twin of the JAX
``lax.scan`` path) or through the CUDA recurrence kernels
(``scan_impl="pallas"``, the twin of the JAX Pallas path:
``ops.rnn_cuda.lstm_scan`` / ``gated_scan`` / ``peephole_scan`` for
inference and the differentiable ``lstm_scan_train`` /
``gated_scan_train`` / ``peephole_scan_train`` when training, as
``networks.py:268-271`` picks the ``*_pallas_train`` kernels; the CUDA
kernels for CUDA tensors, their plain bf16-operand versions for CPU
tensors). A cell with no kernel for a mode takes the step loop on that
route too, as the JAX runner falls back to ``lax.scan``
(``networks.py:267-284``): the zoneout LSTMs serve through
``lstm_scan`` (zoneout is the identity at eval) and train through their
float32 step loop with zoneout masks, on the card as well, with no
kernel.

The gated stacks carry ``(h, fresh)`` per layer (``cells.gru_init_state``).
On the kernel route the converted-checkpoint U biases (``bu``, ``bu_z``,
``bu_r``), when the loaded params carry them, are folded into proj and
gated off at a fresh step 0 (``networks.py:437-443``, ``:491-497``), and
``fresh`` comes back as zeros.

Dropout is the JAX package's placement (``networks.py:42-47``, the
reference's): inverted dropout ``x / (1 - rate)``, only when training,
its masks drawn from the ``torch.Generator`` the caller passes; the
recurrent nets apply it to the input and after every layer, the MLP
after each hidden activation, the TDNN after each conv activation; the
zoneout masks come from the same generator. ``ZoneoutLSTM`` has no
dropout at all.

Parameter names follow the JAX pytree paths with ``.`` for ``/``
(``cells.0.wx``, ``hidden.0.w``, ``conv.0.w``, ``out.w``), so
``train.checkpoint.load_jax_params`` output loads with
``load_state_dict``. Weights keep the JAX layouts (dense ``(in, out)``,
TDNN kernels ``(k, d_in, d_out)``); nothing is transposed at rest.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.rnn_cuda import (
    ACTIVATIONS,
    gated_scan,
    gated_scan_train,
    lstm_scan,
    lstm_scan_train,
    peephole_scan,
    peephole_scan_train,
)
from ..utils.device import resolve_device
from ..utils.profiling import span
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
    """A dense layer, ``x @ w + b`` (``parallel.mesh`` swaps it for a
    column-parallel one over a ``model`` axis)."""

    def __init__(self, params):
        super().__init__()
        self.w = nn.Parameter(params["w"])
        self.b = nn.Parameter(params["b"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class _Conv(_Dense):
    """A TDNN layer: the VALID cross-correlation of (N, d_in, W) with the
    ``(k, d_in, d_out)`` kernel, plus the bias."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, self.w.permute(2, 1, 0)) + self.b[:, None]


class _Layer(nn.Module):
    """One recurrent layer's parameters under their JAX names.

    The converted-checkpoint U biases (``OPTIONAL``) are registered when
    a loaded state dict carries them, so ``load_state_dict`` takes the
    params the JAX network would take."""

    OPTIONAL = ("bu", "bu_z", "bu_r")

    def __init__(self, params):
        super().__init__()
        for name, value in params.items():
            self.register_parameter(name, nn.Parameter(value))

    def params(self):
        """name -> tensor, read through the attributes (so
        ``torch.func.functional_call`` substitutes its own)."""
        return {name: getattr(self, name) for name, _ in
                self.named_parameters(recurse=False)}

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        like = next(iter(self.parameters()))
        for name in self.OPTIONAL:
            value = state_dict.get(prefix + name)
            if value is not None and name not in self._parameters:
                self.register_parameter(name, nn.Parameter(torch.empty(
                    value.shape, dtype=like.dtype, device=like.device)))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def _fold_u_bias(proj: torch.Tensor, bu: torch.Tensor,
                 fresh: torch.Tensor) -> torch.Tensor:
    """Add the U-side biases of a converted checkpoint to every step of
    proj (T, B, G*H), gated off at step 0 of the rows that start fresh
    (Chainer skips the whole U term while ``h is None``)."""
    proj = proj + bu
    return torch.cat([proj[:1] - fresh[None] * bu, proj[1:]])


# ---------------------------------------------------------------------------
# Feed-forward
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """MLP twin (chainer_networks.py:8-22): ``layers`` hidden layers of
    ``units``, activation and dropout after each, linear output.

    ``in_dim`` is the feature width (the JAX ``init``'s argument);
    weights are drawn from ``seed`` (they do not equal the JAX init; load
    shared weights for parity)."""

    is_recurrent = False

    def __init__(self, units: int, num_classes: int, layers: int = 2,
                 dropout: float = 0.0, activation: str = "relu", *,
                 in_dim: int, device="cuda", seed: int = 0):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        dev = resolve_device(device)
        self.units, self.num_classes, self.layers = units, num_classes, layers
        self.dropout, self.activation = dropout, activation
        gen = torch.Generator().manual_seed(seed)
        hidden = []
        d = in_dim
        for _ in range(layers):
            hidden.append(_Dense(cells.dense_init(d, units, gen)))
            d = units
        self.hidden = nn.ModuleList(hidden)
        self.out = _Dense(cells.dense_init(d, num_classes, gen))
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.out.w.device

    def apply(self, x: torch.Tensor, train: bool = False,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(N, D) -> (N, C) logits."""
        act = ACTIVATIONS[self.activation]
        for layer in self.hidden:
            x = dropout(act(layer(x)), self.dropout, train, generator)
        return self.out(x)

    forward = apply


class TDNN(nn.Module):
    """TDNN twin (chainer_networks.py:24-42): 1-D convolutions over the
    splice window with per-layer kernel sizes, a linear output on the
    collapsed window.

    The input is the spliced flat layout (N, winlen*D) with shift-major
    blocks (``ops.splice_flat``), read as (N, W, D); with
    ``chainer_layout`` it is the reference's raw reshape to (N, D, W)
    instead (JAX ``networks.py:150-154``). Each layer is a VALID
    cross-correlation, ``F.conv1d`` on the ``(k, d_in, d_out)`` kernel
    permuted to ``(d_out, d_in, k)``, as ``conv_general_dilated`` with
    ``WIO`` computes it."""

    is_recurrent = False

    def __init__(self, units: Sequence[int], num_classes: int,
                 ksize: Sequence[int], dropout: float = 0.0,
                 activation: str = "relu", chainer_layout: bool = False, *,
                 in_dim: int, device="cuda", seed: int = 0):
        super().__init__()
        if len(units) != len(ksize):
            raise ValueError("TDNN units must have the same length as ksize")
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        dev = resolve_device(device)
        self.units, self.ksize = tuple(units), tuple(ksize)
        self.num_classes = num_classes
        self.dropout, self.activation = dropout, activation
        self.chainer_layout = chainer_layout
        winlen = self.input_win_size
        if in_dim % winlen != 0:
            raise ValueError(
                f"TDNN input dim {in_dim} not divisible by window {winlen}")
        gen = torch.Generator().manual_seed(seed)
        d = in_dim // winlen
        conv = []
        for u, k in zip(self.units, self.ksize):
            w = torch.randn(k, d, u, generator=gen) / math.sqrt(k * d)
            conv.append(_Conv({"w": w, "b": torch.zeros(u)}))
            d = u
        self.conv = nn.ModuleList(conv)
        self.out = _Dense(cells.dense_init(d, num_classes, gen))
        self.to(dev)

    @property
    def input_win_size(self) -> int:
        return sum(self.ksize) - len(self.ksize) + 1

    @property
    def device(self) -> torch.device:
        return self.out.w.device

    def apply(self, x: torch.Tensor, train: bool = False,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(N, winlen*D) -> (N, C) logits."""
        act = ACTIVATIONS[self.activation]
        n = x.shape[0]
        winlen = self.input_win_size
        if self.chainer_layout:
            x = x.reshape(n, -1, winlen)                    # (N, C=D, W)
        else:
            x = x.reshape(n, winlen, -1).transpose(1, 2)    # (N, D, W)
        for layer in self.conv:
            x = dropout(act(layer(x)), self.dropout, train, generator)
        x = x.reshape(n, -1)                     # the window collapsed to 1
        return self.out(x)

    forward = apply



class _RecurrentStack(nn.Module):
    """Shared machinery of the stacked recurrent nets (the JAX
    ``_RecurrentStack``). Subclasses give the cell hooks below.

    ``in_dim`` is the feature width (the JAX ``init``'s argument).
    Weights are drawn from ``seed`` with a ``torch.Generator`` (they do
    not equal the JAX init; load shared weights for parity).
    """

    is_recurrent = True

    def __init__(self, units: int, num_classes: int, layers: int,
                 dropout: float, *, in_dim: int, scan_impl: str, device,
                 seed: int):
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
            layer_list.append(_Layer(self._cell_init(d, gen)))
            d = units
        self.cells = nn.ModuleList(layer_list)
        self.out = _Dense(cells.dense_init(d, num_classes, gen))
        self.to(dev)

    # cell hooks --------------------------------------------------------
    def _cell_init(self, in_dim: int, gen: torch.Generator):
        raise NotImplementedError

    def _cell_input_proj(self, p, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _cell_step(self, p, carry, x_proj: torch.Tensor, train: bool = False,
                   generator: Optional[torch.Generator] = None):
        raise NotImplementedError

    def _cell_state(self, batch: int):
        raise NotImplementedError

    def _cell_scan(self, p, carry, proj: torch.Tensor, train: bool):
        """The whole-sequence kernel route: (carry, (T, B, G*H) proj) ->
        (carry', (T, B, H) hiddens), or None where the cell has no kernel
        for this mode, and the runner takes the step loop (the JAX
        ``_cell_scan_pallas*`` hooks' None, ``networks.py:195-204``)."""
        return None

    # ------------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.out.w.device

    def init_state(self, batch: int):
        return [self._cell_state(batch) for _ in range(self.layers)]

    def step(self, state, x: torch.Tensor):
        """One timestep (B, D) -> (new_state, (B, C) logits), float32."""
        new_state = []
        for l in range(self.layers):
            p = self.cells[l].params()
            carry, x = self._cell_step(p, state[l],
                                       self._cell_input_proj(p, x))
            new_state.append(carry)
        return new_state, self.out(x)

    def hidden_sequence(self, xs: torch.Tensor, state=None,
                        train: bool = False,
                        generator: Optional[torch.Generator] = None):
        """(B, T, D) -> ((B, T, H) last-layer hiddens, state); the
        hiddens may be a transposed view of the time-major ones the last
        layer made (``apply_sequence`` copies them batch-major).

        ``train`` turns dropout and zoneout on (masks from
        ``generator``) and, with ``scan_impl="pallas"``, routes the
        recurrence through the differentiable kernels."""
        b, t, _ = xs.shape
        if state is None:
            state = self.init_state(b)
        xs = dropout(xs, self.dropout, train, generator)
        new_state = []
        for l in range(self.layers):
            p = self.cells[l].params()
            with span("nnam.net.input_proj"):
                proj = self._cell_input_proj(p, xs.reshape(b * t, -1))
            with span("nnam.net.layout"):
                proj = proj.reshape(b, t, -1).transpose(0, 1).contiguous()
            scanned = (self._cell_scan(p, state[l], proj, train)
                       if self.scan_impl == "pallas" else None)
            if scanned is not None:
                carry, hs = scanned
            else:
                carry = state[l]
                steps = []
                for k in range(t):
                    carry, h = self._cell_step(p, carry, proj[k], train,
                                               generator)
                    steps.append(h)
                hs = torch.stack(steps)
            new_state.append(carry)
            xs = dropout(hs.transpose(0, 1), self.dropout, train,
                         generator)                       # (B, T, H)
            if l + 1 < self.layers:
                # the copy the next layer's input projection would make
                # of the transposed xs in its reshape
                with span("nnam.net.layout"):
                    xs = xs.contiguous()
        return xs, new_state

    def apply_sequence(self, xs: torch.Tensor, state=None,
                       train: bool = False,
                       generator: Optional[torch.Generator] = None):
        """(B, T, D) -> ((B, T, C) logits, state)."""
        b, t, _ = xs.shape
        hs, new_state = self.hidden_sequence(xs, state, train, generator)
        with span("nnam.net.layout"):
            hs = hs.contiguous()        # the time-major hiddens, batch-major
        with span("nnam.net.output"):
            logits = self.out(hs.reshape(b * t, -1))
        return logits.reshape(b, t, -1), new_state

    forward = apply_sequence


class LSTM(_RecurrentStack):
    """LSTM stack twin (chainer_networks.py:44-62)."""

    def __init__(self, units: int, num_classes: int, layers: int = 2,
                 dropout: float = 0.0, *, in_dim: int,
                 scan_impl: str = "xla", device="cuda", seed: int = 0):
        super().__init__(units, num_classes, layers, dropout, in_dim=in_dim,
                         scan_impl=scan_impl, device=device, seed=seed)

    def _cell_init(self, in_dim, gen):
        return cells.lstm_init(in_dim, self.units, gen)

    def _cell_input_proj(self, p, x):
        return cells.lstm_input_proj(p, x)

    def _cell_step(self, p, carry, x_proj, train=False, generator=None):
        return cells.lstm_step(p, carry, x_proj)

    def _cell_state(self, batch):
        return cells.lstm_init_state(batch, self.units, device=self.device)

    def _cell_scan(self, p, carry, proj, train):
        c, h = carry
        scan = lstm_scan_train if train else lstm_scan
        return scan(proj, p["wh"], c, h)


class ZoneoutLSTM(LSTM):
    """Zoneout LSTM stack twin (chainer_networks.py:64-81): the LSTM's
    cell with zoneout on c and h (``c_ratio`` / ``h_ratio``), no dropout
    anywhere. Zoneout passes the new state through at eval, so it serves
    through ``lstm_scan`` on the kernel route; it trains through its step
    loop, with no kernel, on either route (networks.py:352-357)."""

    def __init__(self, units: int, num_classes: int, layers: int = 2,
                 c_ratio: float = 0.5, h_ratio: float = 0.5, *, in_dim: int,
                 scan_impl: str = "xla", device="cuda", seed: int = 0):
        self.c_ratio, self.h_ratio = c_ratio, h_ratio
        super().__init__(units, num_classes, layers, 0.0, in_dim=in_dim,
                         scan_impl=scan_impl, device=device, seed=seed)

    def _cell_step(self, p, carry, x_proj, train=False, generator=None):
        return cells.zoneout_lstm_step(p, carry, x_proj, c_ratio=self.c_ratio,
                                       h_ratio=self.h_ratio, train=train,
                                       generator=generator)

    def _cell_scan(self, p, carry, proj, train):
        return None if train else super()._cell_scan(p, carry, proj, train)


class ZoneoutDropoutLSTM(ZoneoutLSTM):
    """Zoneout LSTM with dropout on the input and after every layer
    (chainer_networks.py:83-101)."""

    def __init__(self, units: int, num_classes: int, layers: int = 2,
                 dropout: float = 0.0, c_ratio: float = 0.5,
                 h_ratio: float = 0.5, *, in_dim: int, scan_impl: str = "xla",
                 device="cuda", seed: int = 0):
        super().__init__(units, num_classes, layers, c_ratio, h_ratio,
                         in_dim=in_dim, scan_impl=scan_impl, device=device,
                         seed=seed)
        self.dropout = dropout


class PeepholeLSTM(_RecurrentStack):
    """Peephole LSTM stack twin (chainer_networks.py:103-121)."""

    def __init__(self, units: int, num_classes: int, layers: int = 2,
                 dropout: float = 0.0, *, in_dim: int,
                 scan_impl: str = "xla", device="cuda", seed: int = 0):
        super().__init__(units, num_classes, layers, dropout, in_dim=in_dim,
                         scan_impl=scan_impl, device=device, seed=seed)

    def _cell_init(self, in_dim, gen):
        return cells.peephole_lstm_init(in_dim, self.units, gen)

    def _cell_input_proj(self, p, x):
        return cells.lstm_input_proj(p, x)

    def _cell_step(self, p, carry, x_proj, train=False, generator=None):
        return cells.peephole_lstm_step(p, carry, x_proj)

    def _cell_state(self, batch):
        return cells.lstm_init_state(batch, self.units, device=self.device)

    def _cell_scan(self, p, carry, proj, train):
        c, h = carry
        scan = peephole_scan_train if train else peephole_scan
        return scan(proj, p["wh"], p["peep_i"], p["peep_f"], p["peep_o"], c,
                    h)


class GRU(_RecurrentStack):
    """GRU stack twin (chainer_networks.py:123-141)."""

    def __init__(self, units: int, num_classes: int, layers: int = 2,
                 dropout: float = 0.0, *, in_dim: int,
                 scan_impl: str = "xla", device="cuda", seed: int = 0):
        super().__init__(units, num_classes, layers, dropout, in_dim=in_dim,
                         scan_impl=scan_impl, device=device, seed=seed)

    def _cell_init(self, in_dim, gen):
        return cells.gru_init(in_dim, self.units, gen)

    def _cell_input_proj(self, p, x):
        return cells.gru_input_proj(p, x)

    def _cell_step(self, p, carry, x_proj, train=False, generator=None):
        return cells.gru_step(p, carry, x_proj)

    def _cell_state(self, batch):
        return cells.gru_init_state(batch, self.units, device=self.device)

    def _cell_scan(self, p, carry, proj, train):
        h, fresh = carry
        if "bu" in p:
            proj = _fold_u_bias(proj, p["bu"], fresh)
        scan = gated_scan_train if train else gated_scan
        h_t, hs = scan(proj, p["wh_rz"], p["wh_c"], h, kind="gru")
        return (h_t, torch.zeros_like(fresh)), hs


class MGRUNet(_RecurrentStack):
    """Minimal-GRU stack twin (chainer_networks.py:143-161, MGRU.py)."""

    def __init__(self, units: int, num_classes: int, layers: int = 2,
                 dropout: float = 0.0, use_reset_gate: bool = False,
                 activation: str = "relu", *, in_dim: int,
                 scan_impl: str = "xla", device="cuda", seed: int = 0):
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.use_reset_gate = use_reset_gate
        self.activation = activation
        super().__init__(units, num_classes, layers, dropout, in_dim=in_dim,
                         scan_impl=scan_impl, device=device, seed=seed)

    def _cell_init(self, in_dim, gen):
        return cells.mgru_init(in_dim, self.units, self.use_reset_gate, gen)

    def _cell_input_proj(self, p, x):
        return cells.mgru_input_proj(p, x, self.use_reset_gate)

    def _cell_step(self, p, carry, x_proj, train=False, generator=None):
        return cells.mgru_step(p, carry, x_proj,
                               use_reset_gate=self.use_reset_gate,
                               activation=ACTIVATIONS[self.activation])

    def _cell_state(self, batch):
        return cells.gru_init_state(batch, self.units, device=self.device)

    def _cell_scan(self, p, carry, proj, train):
        h, fresh = carry
        if "bu_z" in p or "bu_r" in p:
            zero = torch.zeros_like(p["b"])
            bu = torch.cat([p.get("bu_z", zero), p.get("bu", zero)]
                           + ([p.get("bu_r", zero)] if self.use_reset_gate
                              else []))
            proj = _fold_u_bias(proj, bu, fresh)
        scan = gated_scan_train if train else gated_scan
        if self.use_reset_gate:
            w1 = torch.cat([p["u_z"], p["u_r"]], dim=1)
            h_t, hs = scan(proj, w1, p["u"], h, kind="mgru_r",
                           activation=self.activation)
        else:
            w1 = torch.cat([p["u_z"], p["u"]], dim=1)
            h_t, hs = scan(proj, w1, None, h, kind="mgru",
                           activation=self.activation)
        return (h_t, torch.zeros_like(fresh)), hs


def redraw_params(net: nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """A new draw of ``net``'s parameters (``state_dict`` names, its
    devices and dtypes) from ``seed``, by the zoo's init rule: every
    matrix or kernel normal over sqrt(fan_in), its leading dims (the
    ``dense_init`` / cell inits / TDNN kernels above); every bias the
    net's own (the inits' constants: zero, the LSTM's forget bias 1).
    What the JAX package gets from a fresh ``net.init(key)``: another
    init of the same architecture."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in net.state_dict().items():
        if p.dim() >= 2:
            w = torch.randn(tuple(p.shape), generator=gen) / math.sqrt(
                math.prod(p.shape[:-1]))
            out[name] = w.to(p.device, p.dtype)
        else:
            out[name] = p.detach().clone()
    return out


def get_network(network: str, layers: int, units: Sequence[int],
                num_classes: int, activation: str = "relu",
                tdnn_ksize: Sequence[int] = (5,),
                dropout: Sequence[float] = (0.0,), *, in_dim: int,
                scan_impl: str = "xla", device="cuda", seed: int = 0):
    """Twin of get_nn (chainer_networks.py:163-187), with the JAX
    argument mapping (``networks.py:538-581``): ``"ff"`` is an MLP of
    ``layers`` x ``units[0]``, ``"tdnn"`` a TDNN of ``units`` with
    ``tdnn_ksize``, both with ``activation`` and ``dropout[0]``
    (``scan_impl`` does not apply to them). As in the JAX package, the
    MGRU nets keep their default relu candidate and ignore
    ``activation``, and the
    dropout list maps positionally (``networks.py:553-568``): onto
    ``(c_ratio, h_ratio)`` for ``zoneoutlstm`` and onto ``(dropout,
    c_ratio, h_ratio)`` for ``zoneoutdropoutlstm``, the ratios 0.5 where
    the list is shorter."""
    dropout = (list(dropout) if not isinstance(dropout, (int, float))
               else [dropout])
    if network == "ff":
        return MLP(units=units[0], num_classes=num_classes, layers=layers,
                   dropout=dropout[0], activation=activation, in_dim=in_dim,
                   device=device, seed=seed)
    if network == "tdnn":
        return TDNN(units=tuple(units), num_classes=num_classes,
                    ksize=tuple(tdnn_ksize), dropout=dropout[0],
                    activation=activation, in_dim=in_dim, device=device,
                    seed=seed)
    kw = dict(in_dim=in_dim, scan_impl=scan_impl, device=device, seed=seed)
    if network == "lstm":
        return LSTM(units=units[0], num_classes=num_classes, layers=layers,
                    dropout=dropout[0], **kw)
    if network == "zoneoutlstm":
        return ZoneoutLSTM(units=units[0], num_classes=num_classes,
                           layers=layers,
                           c_ratio=dropout[0] if len(dropout) >= 1 else 0.5,
                           h_ratio=dropout[1] if len(dropout) >= 2 else 0.5,
                           **kw)
    if network == "zoneoutdropoutlstm":
        return ZoneoutDropoutLSTM(
            units=units[0], num_classes=num_classes, layers=layers,
            dropout=dropout[0] if len(dropout) >= 1 else 0.0,
            c_ratio=dropout[1] if len(dropout) >= 2 else 0.5,
            h_ratio=dropout[2] if len(dropout) >= 3 else 0.5, **kw)
    if network == "peepholelstm":
        return PeepholeLSTM(units=units[0], num_classes=num_classes,
                            layers=layers, dropout=dropout[0], **kw)
    if network == "gru":
        return GRU(units=units[0], num_classes=num_classes, layers=layers,
                   dropout=dropout[0], **kw)
    if network in ("mgrurelu", "mgrurelur"):
        return MGRUNet(units=units[0], num_classes=num_classes, layers=layers,
                       dropout=dropout[0],
                       use_reset_gate=network == "mgrurelur", **kw)
    raise ValueError(f"unknown network type: {network}")


def is_recurrent(network: str) -> bool:
    """Name-based predicate, twin of is_nn_recurrent
    (chainer_networks.py:186-187)."""
    return (network.endswith("lstm") or network.startswith("gru")
            or network.startswith("mgru"))
