"""bfloat16 compute with float32 master weights.

Counterpart of ``nnacousticmodeling_tpu/models/precision.py``. The casts
are ordinary tensor ops inside autograd, so a loss computed through the
cast parameters sends float32 gradients back to the float32 master
parameters (each gradient rounded to bf16 first, as in the JAX package,
where the cast sits inside the differentiated function).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.func import functional_call


def cast_params(params: Dict[str, torch.Tensor], dtype=torch.bfloat16
                ) -> Dict[str, torch.Tensor]:
    """Cast every floating-point tensor; integer tensors untouched."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in params.items()}


def _cast_state(state, dtype):
    return [tuple(a.to(dtype) if a.is_floating_point() else a for a in s)
            for s in state]


class HalfPrecisionNet:
    """Wraps a network for bf16 compute with float32 outputs: parameters,
    inputs and (recurrent nets) the initial state are cast to ``dtype``,
    the logits come back as float32. Works with the feed-forward
    ``apply`` and the recurrent ``apply_sequence``, so it drops into
    ``ff_log_posteriors``, ``rnn_log_posteriors`` and the training engine
    like the network itself (the FF stage's ``compute_dtype="bfloat16"``
    is the JAX ``_mixed_apply``, ``engine.py:206-220``)."""

    def __init__(self, net, dtype=torch.bfloat16):
        self.net = net
        self.dtype = dtype
        self.is_recurrent = getattr(net, "is_recurrent", False)

    @property
    def device(self) -> torch.device:
        return self.net.device

    def cast(self) -> Dict[str, torch.Tensor]:
        return cast_params(dict(self.net.named_parameters()), self.dtype)

    def apply(self, x, train=False, generator=None):
        y = functional_call(self.net, self.cast(), (x.to(self.dtype),),
                            {"train": train, "generator": generator})
        return y.float()

    def init_state(self, batch: int):
        return _cast_state(self.net.init_state(batch), self.dtype)

    def apply_sequence(self, xs, state=None, train=False, generator=None):
        if state is None:
            state = self.init_state(xs.shape[0])
        y, new_state = functional_call(
            self.net, self.cast(), (xs.to(self.dtype), state),
            {"train": train, "generator": generator})
        return y.float(), new_state
