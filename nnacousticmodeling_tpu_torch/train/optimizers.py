"""Optimizers matching the reference's Chainer configurations
(train.py:296-305): SGD(lr), MomentumSGD(lr, momentum=0.9), and Adam
with Chainer 3.5 defaults (alpha=1e-3, beta1=0.9, beta2=0.999,
eps=1e-8; the staged ``lr`` is ignored for adam, train.py:286-287).

Counterpart of the JAX package's ``train/optimizers.py``. torch's
``SGD(momentum=0.9, dampening=0, nesterov=False)`` keeps
``buf = g + 0.9 * buf`` and steps ``-lr * buf``, the same update as
``optax.sgd(lr, momentum=0.9)``.

Adam over CUDA params is ``capturable``: it keeps its step count on the
device, so that a step can be captured in a CUDA graph (the training
engine's updates on the card), and computes its bias corrections there,
in another order than the host's. SGD has no host state.
"""

from __future__ import annotations

from typing import Iterable

import torch


def make_optimizer(name: str, lr: float, params: Iterable[torch.Tensor]
                   ) -> torch.optim.Optimizer:
    params = list(params)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr)
    if name == "momentumsgd":
        return torch.optim.SGD(params, lr=lr, momentum=0.9, dampening=0.0,
                               nesterov=False)
    if name == "adam":
        return torch.optim.Adam(
            params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
            capturable=any(p.device.type == "cuda" for p in params))
    raise ValueError(f"unknown optimizer: {name}")
