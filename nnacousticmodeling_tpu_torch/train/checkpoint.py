"""Weights carried across from and to the JAX package.

``nnacousticmodeling_tpu/train/checkpoint.py::save_pytree`` writes a
pytree of parameters to ``.npz`` under path keys such as
``cells/0/wx``, ``cells/0/wh``, ``cells/0/b``, ``out/w``, ``out/b``.
``load_jax_params`` turns such a file, or the same nested dict of numpy
arrays, into the port's parameter dict (``cells.0.wx``, ...), ready for
``nn.Module.load_state_dict``. Layouts are kept as they are: dense
``(in, out)`` matrices, nothing transposed, so both packages compute the
same function.

``save_pytree`` / ``load_pytree`` are the port's side of the same
format (the JAX package's ``train/checkpoint.py:16-48``): a model the
port trained is written under the JAX keys, so the JAX ``load_pytree``
reads it, and ``load_jax_params`` reads it back.
"""

from __future__ import annotations

from os import PathLike
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from ..utils.device import resolve_device


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def load_jax_params(src: Union[str, PathLike, dict], device="cuda"
                    ) -> Dict[str, torch.Tensor]:
    """``save_pytree`` ``.npz`` path or nested numpy dict -> dict of
    float32 tensors on ``device`` keyed ``cells.0.wx``, ``out.w``, ..."""
    dev = resolve_device(device)
    flat: Dict[str, np.ndarray] = {}
    if isinstance(src, dict):
        _flatten(src, "", flat)
    else:
        with np.load(src) as data:
            for key in data.files:
                flat[key.replace("/", ".")] = data[key]
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
            for k, v in flat.items()}


def _as_params(tree) -> Dict[str, torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        return dict(tree.state_dict())
    return dict(tree)


def save_pytree(filename: Union[str, PathLike],
                params: Union[torch.nn.Module, Mapping[str, torch.Tensor]]
                ) -> None:
    """Write a module's parameters (or a ``state_dict``-style mapping)
    to ``.npz`` under the JAX path keys (``cells.0.wx`` ->
    ``cells/0/wx``). ``np.savez`` appends ``.npz`` to a bare name."""
    arrays = {k.replace(".", "/"): v.detach().cpu().numpy()
              for k, v in _as_params(params).items()}
    np.savez(filename, **arrays)


def params_from_arrays(arrays: Mapping[str, np.ndarray],
                       template: Union[torch.nn.Module,
                                       Mapping[str, torch.Tensor]],
                       prefix: str = "") -> Dict[str, torch.Tensor]:
    """The tensors of ``template`` (a module or a ``state_dict``-style
    mapping) read from ``arrays`` under their JAX path keys, each with
    the template's dtype and device. Missing keys and other shapes
    raise."""
    out = {}
    for key, leaf in _as_params(template).items():
        path = prefix + key.replace(".", "/")
        if path not in arrays:
            raise KeyError(f"checkpoint missing {path}")
        arr = arrays[path]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"checkpoint {path}: shape {arr.shape} != "
                             f"template {tuple(leaf.shape)}")
        out[key] = torch.from_numpy(np.array(arr)).to(leaf.device, leaf.dtype)
    return out


def load_pytree(filename: Union[str, PathLike],
                template: Union[torch.nn.Module, Mapping[str, torch.Tensor]]
                ) -> Dict[str, torch.Tensor]:
    """Read a ``save_pytree`` file into a dict shaped like ``template``
    (see ``params_from_arrays``)."""
    with np.load(filename) as data:
        return params_from_arrays(data, template)
