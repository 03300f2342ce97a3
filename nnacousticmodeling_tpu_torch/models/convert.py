"""Chainer checkpoint conversion.

Counterpart of ``nnacousticmodeling_tpu/models/convert.py``, in numpy:
the converters return the JAX package's parameter pytrees (nested dicts
and lists of float32 arrays under the JAX keys), array for array what
the JAX converters return. ``to_port_params`` carries such a tree into
a network of this package through ``params_from_arrays``.

Maps the reference's Chainer ``.npz`` model files (saved via
``chainer.serializers.save_npz(L.Classifier(model))`` — train.py:393)
onto this framework's parameter pytrees, so framewise posterior
parity can be checked against reference-trained models.

Layout facts encoded here:

* Chainer ``L.Linear`` stores W as (out, in) — transposed vs ours.
* ``L.LSTM``: ``upward`` (W x + b) and ``lateral`` (U h, no bias) of
  width 4H with INTERLEAVED gates — unit h's gate g lives at row
  ``h*4 + g`` with gate order (a, i, f, o). Ours packs gates in blocks
  [a | i | f | o] of width H each.
* ``L.GRU`` / MGRU: six separate Linear links (W_r, U_r, W_z, U_z, W,
  U), every one with its own bias, and the whole U term — bias included
  — is skipped while ``h is None`` (the first step after a reset). The
  W biases go to the input projection; the U biases convert to the
  cells' first-step-gated ``bu*`` params so first-frame outputs match
  Chainer exactly.
* ``L.StatefulPeepholeLSTM``: upward/lateral like LSTM plus full-matrix
  ``peep_i/f/o`` links (no bias).
* RPL4: parameters W, b, lb of shape (1, C) — identical layout.

Keys look like ``predictor/layer_0/upward/W``; the ``predictor/``
prefix comes from the Classifier wrapper.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..train.checkpoint import params_from_arrays


def _arr(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _deinterleave_gates(w_4h: np.ndarray) -> np.ndarray:
    """Chainer (4H, X) interleaved rows (h*4+g, gate order a,i,f,o) ->
    our (X, 4H) block columns [a|i|f|o]."""
    h4, x = w_4h.shape
    h = h4 // 4
    blocks = [w_4h[g::4, :] for g in range(4)]     # each (H, X), order a,i,f,o
    return np.concatenate(blocks, axis=0).T.astype(np.float32)  # (X, 4H)


def _deinterleave_bias(b_4h: np.ndarray) -> np.ndarray:
    h = b_4h.shape[0] // 4
    return np.concatenate([b_4h[g::4] for g in range(4)]).astype(np.float32)


def _lin(w):  # chainer (out, in) -> ours (in, out)
    return np.asarray(w, dtype=np.float32).T


def convert_dense(src: Mapping[str, np.ndarray], prefix: str) -> Dict:
    return {"w": _arr(_lin(src[f"{prefix}/W"])),
            "b": _arr(np.asarray(src[f"{prefix}/b"], np.float32))}


def convert_mlp(src: Mapping[str, np.ndarray], layers: int,
                prefix: str = "predictor") -> Dict:
    return {
        "hidden": [convert_dense(src, f"{prefix}/layer_{l}")
                   for l in range(layers)],
        "out": convert_dense(src, f"{prefix}/out"),
    }


def convert_lstm(src: Mapping[str, np.ndarray], layers: int,
                 prefix: str = "predictor") -> Dict:
    cells = []
    for l in range(layers):
        p = f"{prefix}/layer_{l}"
        cells.append({
            "wx": _arr(_deinterleave_gates(np.asarray(src[f"{p}/upward/W"]))),
            "wh": _arr(_deinterleave_gates(np.asarray(src[f"{p}/lateral/W"]))),
            "b": _arr(_deinterleave_bias(np.asarray(src[f"{p}/upward/b"]))),
        })
    return {"cells": cells, "out": convert_dense(src, f"{prefix}/out")}


# ZoneoutLSTM uses the same upward/lateral layout as LSTM
convert_zoneout_lstm = convert_lstm


def convert_peephole_lstm(src: Mapping[str, np.ndarray], layers: int,
                          prefix: str = "predictor") -> Dict:
    cells = []
    for l in range(layers):
        p = f"{prefix}/layer_{l}"
        cells.append({
            "wx": _arr(_deinterleave_gates(np.asarray(src[f"{p}/upward/W"]))),
            "wh": _arr(_deinterleave_gates(np.asarray(src[f"{p}/lateral/W"]))),
            "b": _arr(_deinterleave_bias(np.asarray(src[f"{p}/upward/b"]))),
            "peep_i": _arr(_lin(src[f"{p}/peep_i/W"])),
            "peep_f": _arr(_lin(src[f"{p}/peep_f/W"])),
            "peep_o": _arr(_lin(src[f"{p}/peep_o/W"])),
        })
    return {"cells": cells, "out": convert_dense(src, f"{prefix}/out")}


def convert_gru(src: Mapping[str, np.ndarray], layers: int,
                prefix: str = "predictor") -> Dict:
    cells = []
    for l in range(layers):
        p = f"{prefix}/layer_{l}"
        w_r, b_wr = _lin(src[f"{p}/W_r/W"]), np.asarray(src[f"{p}/W_r/b"])
        u_r, b_ur = _lin(src[f"{p}/U_r/W"]), np.asarray(src[f"{p}/U_r/b"])
        w_z, b_wz = _lin(src[f"{p}/W_z/W"]), np.asarray(src[f"{p}/W_z/b"])
        u_z, b_uz = _lin(src[f"{p}/U_z/W"]), np.asarray(src[f"{p}/U_z/b"])
        w, b_w = _lin(src[f"{p}/W/W"]), np.asarray(src[f"{p}/W/b"])
        u, b_u = _lin(src[f"{p}/U/W"]), np.asarray(src[f"{p}/U/b"])
        cells.append({
            "wx": _arr(np.concatenate([w_r, w_z, w], axis=1)),
            "bx": _arr(np.concatenate(
                [b_wr, b_wz, b_w]).astype(np.float32)),
            # U-side biases, skipped on the first step after a state
            # reset exactly like Chainer's ``h is None`` branch
            "bu": _arr(np.concatenate(
                [b_ur, b_uz, b_u]).astype(np.float32)),
            "wh_rz": _arr(np.concatenate([u_r, u_z], axis=1)),
            "wh_c": _arr(u),
        })
    return {"cells": cells, "out": convert_dense(src, f"{prefix}/out")}


def convert_mgru(src: Mapping[str, np.ndarray], layers: int,
                 use_reset_gate: bool, prefix: str = "predictor") -> Dict:
    cells = []
    for l in range(layers):
        p = f"{prefix}/layer_{l}"
        cell = {
            "w_z": _arr(_lin(src[f"{p}/W_z/W"])),
            "u_z": _arr(_lin(src[f"{p}/U_z/W"])),
            "w": _arr(_lin(src[f"{p}/W/W"])),
            "u": _arr(_lin(src[f"{p}/U/W"])),
            "b_z": _arr(np.asarray(src[f"{p}/W_z/b"], np.float32)),
            "b": _arr(np.asarray(src[f"{p}/W/b"], np.float32)),
            # U-side biases, first-step gated (see cells.gru_init_state)
            "bu_z": _arr(np.asarray(src[f"{p}/U_z/b"], np.float32)),
            "bu": _arr(np.asarray(src[f"{p}/U/b"], np.float32)),
        }
        if use_reset_gate:
            cell["w_r"] = _arr(_lin(src[f"{p}/W_r/W"]))
            cell["u_r"] = _arr(_lin(src[f"{p}/U_r/W"]))
            cell["b_r"] = _arr(np.asarray(src[f"{p}/W_r/b"], np.float32))
            cell["bu_r"] = _arr(np.asarray(src[f"{p}/U_r/b"], np.float32))
        cells.append(cell)
    return {"cells": cells, "out": convert_dense(src, f"{prefix}/out")}


def convert_tdnn(src: Mapping[str, np.ndarray], num_layers: int,
                 prefix: str = "predictor") -> Dict:
    """Chainer TDNN (Convolution2D ksize (1, k), chainer_networks.py:35)
    -> our conv params. Requires a TDNN built with chainer_layout=True,
    which reproduces the reference's raw (channels=D, width=winlen)
    reshape of the spliced input."""
    conv = []
    for l in range(num_layers):
        w = np.asarray(src[f"{prefix}/layer_{l}/W"], np.float32)  # (out,in,1,k)
        b = np.asarray(src[f"{prefix}/layer_{l}/b"], np.float32)
        conv.append({"w": _arr(w[:, :, 0, :].transpose(2, 1, 0)),
                     "b": _arr(b)})
    return {"conv": conv, "out": convert_dense(src, f"{prefix}/out")}


def convert_rpl4(src: Mapping[str, np.ndarray],
                 prefix: str = "predictor") -> Dict:
    return {
        "w": _arr(np.asarray(src[f"{prefix}/W"], np.float32)),
        "b": _arr(np.asarray(src[f"{prefix}/b"], np.float32)),
        "lb": _arr(np.asarray(src[f"{prefix}/lb"], np.float32)),
    }


def convert_checkpoint(npz_path: str, network: str, layers: int,
                       prefix: str = "predictor") -> Dict:
    """Load + convert a reference .npz by network type name."""
    src = dict(np.load(npz_path))
    if network == "ff":
        return convert_mlp(src, layers, prefix)
    if network == "tdnn":
        return convert_tdnn(src, layers, prefix)
    if network in ("lstm", "zoneoutlstm", "zoneoutdropoutlstm"):
        return convert_lstm(src, layers, prefix)
    if network == "peepholelstm":
        return convert_peephole_lstm(src, layers, prefix)
    if network == "gru":
        return convert_gru(src, layers, prefix)
    if network == "mgrurelu":
        return convert_mgru(src, layers, False, prefix)
    if network == "mgrurelur":
        return convert_mgru(src, layers, True, prefix)
    raise ValueError(f"no converter for network {network!r}")


def _flat(tree, prefix: str, out: Dict[str, np.ndarray]) -> Dict:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flat(v, f"{prefix}{i}/", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def to_port_params(tree, net: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A converted pytree as ``net``'s state dict (name -> tensor on the
    net's device), read by ``params_from_arrays`` under the JAX path
    keys. The gated nets' first-step U biases (``bu``, ``bu_z``,
    ``bu_r``), which natively built nets do not carry, are registered
    on the net first (``networks._Layer``), so the converted params
    load whole."""
    arrays = _flat(tree, "", {})
    extra = {k.replace("/", "."): torch.from_numpy(v) for k, v in
             arrays.items() if k.rsplit("/", 1)[-1] in ("bu", "bu_z",
                                                         "bu_r")}
    if extra:
        net.load_state_dict({**net.state_dict(), **extra})
    return params_from_arrays(arrays, net)
