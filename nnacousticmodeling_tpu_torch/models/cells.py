"""The recurrent cells (LSTM, zoneout LSTM, peephole LSTM, GRU, MGRU) as
plain functions on tensors.

Counterpart of ``nnacousticmodeling_tpu/models/cells.py``: Chainer
``L.LSTM`` gate order a, i, f, o with forget-gate bias 1 at init, the
peephole LSTM's zero bias and full (H, H) peephole matrices, the gated
cells with the JAX package's parameter names and proj packing, dense
``(in, out)`` weight matrices.
The input projection of a whole sequence is hoisted out of the
recurrence by the stacks in ``networks.py``; only the recurrent products
run per step.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def dense_init(in_dim: int, out_dim: int, generator: torch.Generator
               ) -> Dict[str, torch.Tensor]:
    """Normal weights scaled by 1/sqrt(fan_in), zero bias."""
    w = torch.randn(in_dim, out_dim, generator=generator) / math.sqrt(in_dim)
    return {"w": w, "b": torch.zeros(out_dim)}


def dense(params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]


def lstm_init(in_dim: int, units: int, generator: torch.Generator
              ) -> Dict[str, torch.Tensor]:
    b = torch.zeros(4 * units)
    b[2 * units:3 * units] = 1.0          # Chainer forget_bias_init=1
    wx = torch.randn(in_dim, 4 * units, generator=generator) / math.sqrt(
        in_dim)
    wh = torch.randn(units, 4 * units, generator=generator) / math.sqrt(units)
    return {"wx": wx, "wh": wh, "b": b}


def lstm_gates(units: int, z: torch.Tensor):
    """Split a (B, 4H) pre-activation into a (candidate), i, f, o."""
    a = torch.tanh(z[:, 0 * units:1 * units])
    i = torch.sigmoid(z[:, 1 * units:2 * units])
    f = torch.sigmoid(z[:, 2 * units:3 * units])
    o = torch.sigmoid(z[:, 3 * units:4 * units])
    return a, i, f, o


def lstm_step(params, carry: Tuple[torch.Tensor, torch.Tensor],
              x_proj: torch.Tensor):
    """One float32 LSTM step on a precomputed input projection (B, 4H)."""
    c, h = carry
    units = c.shape[-1]
    z = x_proj + h @ params["wh"]
    a, i, f, o = lstm_gates(units, z)
    c_new = f * c + i * a
    h_new = o * torch.tanh(c_new)
    return (c_new, h_new), h_new


def lstm_input_proj(params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["wx"] + params["b"]


def lstm_init_state(batch: int, units: int, dtype=torch.float32,
                    device=None):
    z = torch.zeros(batch, units, dtype=dtype, device=device)
    return (z, z)


# ---------------------------------------------------------------------------
# Zoneout LSTM (Chainer L.StatefulZoneoutLSTM twin, cells.py:97-117)
# ---------------------------------------------------------------------------

def zoneout(ratio: float, prev: torch.Tensor, new: torch.Tensor, train: bool,
            generator) -> torch.Tensor:
    """Keep the previous state element-wise with probability ``ratio``
    when training (Chainer ``F.zoneout``), the mask drawn from
    ``generator``; pass the new state through at eval, at ratio 0 and
    without a generator (as ``networks.dropout`` does)."""
    if not train or ratio == 0.0 or generator is None:
        return new
    keep = torch.rand(new.shape, generator=generator,
                      device=new.device) < ratio
    return torch.where(keep, prev, new)


def zoneout_lstm_step(params, carry, x_proj: torch.Tensor, *,
                      c_ratio: float, h_ratio: float, train: bool,
                      generator):
    """``lstm_step`` with zoneout on c, then on h (the masks drawn in that
    order); at eval exactly ``lstm_step``."""
    c, h = carry
    (c_cand, h_cand), _ = lstm_step(params, carry, x_proj)
    c_new = zoneout(c_ratio, c, c_cand, train, generator)
    h_new = zoneout(h_ratio, h, h_cand, train, generator)
    return (c_new, h_new), h_new


# ---------------------------------------------------------------------------
# Peephole LSTM (Chainer L.StatefulPeepholeLSTM twin, cells.py:124-149): the
# upward bias is zero (no forget bias of 1), and the peephole connections
# are full (H, H) matrices, i and f on c_{t-1}, o on c_t.
# ---------------------------------------------------------------------------

def peephole_lstm_init(in_dim: int, units: int, generator: torch.Generator
                       ) -> Dict[str, torch.Tensor]:
    def w(n_in, n_out):
        return torch.randn(n_in, n_out, generator=generator) / math.sqrt(n_in)

    return {"wx": w(in_dim, 4 * units), "wh": w(units, 4 * units),
            "b": torch.zeros(4 * units), "peep_i": w(units, units),
            "peep_f": w(units, units), "peep_o": w(units, units)}


def peephole_lstm_step(params, carry, x_proj: torch.Tensor):
    """One float32 peephole LSTM step on a precomputed input projection."""
    c, h = carry
    units = c.shape[-1]
    z = x_proj + h @ params["wh"]
    a = torch.tanh(z[:, 0 * units:1 * units])
    i = torch.sigmoid(z[:, 1 * units:2 * units] + c @ params["peep_i"])
    f = torch.sigmoid(z[:, 2 * units:3 * units] + c @ params["peep_f"])
    c_new = f * c + i * a
    o = torch.sigmoid(z[:, 3 * units:4 * units] + c_new @ params["peep_o"])
    h_new = o * torch.tanh(c_new)
    return (c_new, h_new), h_new


# ---------------------------------------------------------------------------
# GRU (Chainer L.GRU / StatefulGRU twin, cells.py:159-201): h' = z*h_bar +
# (1-z)*h -- Chainer's z gates the CANDIDATE. The carry is (h, fresh):
# ``fresh`` (B, 1) is 1.0 until the first step has run and gates the U-side
# biases of converted checkpoints (params key "bu"), which Chainer skips
# while ``h is None``; natively initialised params have none.
# ---------------------------------------------------------------------------

def gru_init(in_dim: int, units: int, generator: torch.Generator
             ) -> Dict[str, torch.Tensor]:
    """Packed input projection [r, z, c]; recurrent [r, z] and the
    candidate's U (it multiplies r*h) separate."""
    return {
        "wx": torch.randn(in_dim, 3 * units, generator=generator)
        / math.sqrt(in_dim),
        "bx": torch.zeros(3 * units),
        "wh_rz": torch.randn(units, 2 * units, generator=generator)
        / math.sqrt(units),
        "wh_c": torch.randn(units, units, generator=generator)
        / math.sqrt(units),
    }


def gru_input_proj(params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["wx"] + params["bx"]


def gru_init_state(batch: int, units: int, dtype=torch.float32, device=None):
    return (torch.zeros(batch, units, dtype=dtype, device=device),
            torch.ones(batch, 1, dtype=dtype, device=device))


def gru_step(params, carry, x_proj: torch.Tensor):
    h, fresh = carry
    units = h.shape[-1]
    rz = x_proj[:, :2 * units] + h @ params["wh_rz"]
    c_in = x_proj[:, 2 * units:]
    if "bu" in params:           # converted checkpoints: U biases, gated
        live = 1.0 - fresh
        rz = rz + live * params["bu"][:2 * units]
        c_in = c_in + live * params["bu"][2 * units:]
    r = torch.sigmoid(rz[:, :units])
    z = torch.sigmoid(rz[:, units:])
    h_bar = torch.tanh(c_in + (r * h) @ params["wh_c"])
    h_new = z * h_bar + (1.0 - z) * h
    return (h_new, torch.zeros_like(fresh)), h_new


# ---------------------------------------------------------------------------
# MGRU, the reference's minimal GRU (cells.py:213-256, MGRU.py:67-85):
#   z     = sigmoid(W_z x + U_z h)
#   h_bar = act(W x + U (r*h))          (r only with the reset gate)
#   h'    = z*h_bar + (1-z)*h
# Proj packing [z, c] or, with the reset gate, [z, c, r].
# ---------------------------------------------------------------------------

def mgru_init(in_dim: int, units: int, use_reset_gate: bool,
              generator: torch.Generator) -> Dict[str, torch.Tensor]:
    def w(n_in):
        return torch.randn(n_in, units, generator=generator) / math.sqrt(n_in)

    params = {"w_z": w(in_dim), "u_z": w(units), "w": w(in_dim),
              "u": w(units), "b_z": torch.zeros(units),
              "b": torch.zeros(units)}
    if use_reset_gate:
        params.update(w_r=w(in_dim), u_r=w(units), b_r=torch.zeros(units))
    return params


def mgru_input_proj(params, x: torch.Tensor, use_reset_gate: bool
                    ) -> torch.Tensor:
    proj = [x @ params["w_z"] + params["b_z"], x @ params["w"] + params["b"]]
    if use_reset_gate:
        proj.append(x @ params["w_r"] + params["b_r"])
    return torch.cat(proj, dim=-1)


def mgru_step(params, carry, x_proj: torch.Tensor, *, use_reset_gate: bool,
              activation):
    h, fresh = carry
    units = h.shape[-1]
    z_in = x_proj[:, :units]
    c_in = x_proj[:, units:2 * units]
    if "bu_z" in params:
        live = 1.0 - fresh
        z_in = z_in + live * params["bu_z"]
        c_in = c_in + live * params["bu"]
    z = torch.sigmoid(z_in + h @ params["u_z"])
    if use_reset_gate:
        r_in = x_proj[:, 2 * units:]
        if "bu_r" in params:
            r_in = r_in + (1.0 - fresh) * params["bu_r"]
        r = torch.sigmoid(r_in + h @ params["u_r"])
        h_bar = activation(c_in + (r * h) @ params["u"])
    else:
        h_bar = activation(c_in + h @ params["u"])
    h_new = z * h_bar + (1.0 - z) * h
    return (h_new, torch.zeros_like(fresh)), h_new
