"""Regularization Post Layer calibration heads as ``nn.Module``s.

Counterpart of ``nnacousticmodeling_tpu/models/rpl.py`` (behavioural
twins of the reference's ``scripts/common/RPL.py``): applied to
(already ensemble-averaged) logits, they log-softmax the input and add a
learned residual, with a log-floor ``lb`` merged in through the
reference's ``logaddexp``. RPL4, the variant the pipeline trains, is a
diagonal scale and bias: ``y = logaddexp(ls(x) * (1 + w) + b, lb)`` with
``w`` and ``b`` zero and ``lb`` -20 at init (RPL.py:58-74). The inits of
RPL2-4 are deterministic; RPL1's dense weights are drawn from ``seed``.

Parameter names are the JAX pytree paths (``l.w``, ``l.b``, ``lb``;
``w``, ``b``, ``lb`` for RPL4), so ``load_jax_params`` output loads with
``load_state_dict``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.numerics import log_softmax
from ..utils.device import resolve_device
from . import cells


def _logaddexp(h: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    """The reference's op order, kept as it is (not ``torch.logaddexp``
    or ``log1p``): ``max + log(1 + exp(min - max))``."""
    mx = torch.maximum(h, lb)
    mn = torch.minimum(h, lb)
    return mx + torch.log(1.0 + torch.exp(mn - mx))


class _Head(nn.Module):
    is_recurrent = False

    def __init__(self, num_classes: int, params, device):
        super().__init__()
        self.num_classes = num_classes
        for name, value in params.items():
            if isinstance(value, dict):
                sub = nn.Module()
                for k, v in value.items():
                    sub.register_parameter(k, nn.Parameter(v))
                self.add_module(name, sub)
            else:
                self.register_parameter(name, nn.Parameter(value))
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)


class RPL0(nn.Module):
    """Identity head (RPL.py:8-13)."""

    is_recurrent = False

    def __init__(self, num_classes: int, *, device="cuda", seed: int = 0):
        super().__init__()
        self.num_classes = num_classes
        self._device = resolve_device(device)

    @property
    def device(self) -> torch.device:
        return self._device

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return x

    forward = apply


class RPL1(_Head):
    """Full linear residual head (RPL.py:15-24): y = ls(x) + ls(x) @ W + b."""

    def __init__(self, num_classes: int, *, device="cuda", seed: int = 0):
        gen = torch.Generator().manual_seed(seed)
        super().__init__(num_classes, {"l": cells.dense_init(
            num_classes, num_classes, gen)}, device)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        x = log_softmax(x, dim=-1)
        return x + (x @ self.l.w + self.l.b)


class RPL2(_Head):
    """Zero-init linear residual with a log-floor (RPL.py:26-40). RPL3
    (RPL.py:42-56) is byte-identical to RPL2 in the reference; this class
    serves both."""

    def __init__(self, num_classes: int, *, device="cuda", seed: int = 0):
        n = num_classes
        super().__init__(n, {"l": {"w": torch.zeros(n, n),
                                   "b": torch.zeros(n)},
                             "lb": torch.full((1, n), -20.0)}, device)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        x = log_softmax(x, dim=-1)
        h = x + (x @ self.l.w + self.l.b)
        return _logaddexp(h, self.lb)


RPL3 = RPL2


class RPL4(_Head):
    """Diagonal scale + bias + log-floor (RPL.py:58-74), the variant the
    pipeline trains: y = logaddexp(ls(x) * (1 + w) + b, lb)."""

    def __init__(self, num_classes: int, *, device="cuda", seed: int = 0):
        n = num_classes
        super().__init__(n, {"w": torch.zeros(1, n), "b": torch.zeros(1, n),
                             "lb": torch.full((1, n), -20.0)}, device)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        x = log_softmax(x, dim=-1)
        h = x + x * self.w + self.b
        return _logaddexp(h, self.lb)


RPL_VARIANTS = {0: RPL0, 1: RPL1, 2: RPL2, 3: RPL3, 4: RPL4}


def get_rpl(variant: int, num_classes: int, *, device="cuda", seed: int = 0):
    return RPL_VARIANTS[variant](num_classes, device=device, seed=seed)
