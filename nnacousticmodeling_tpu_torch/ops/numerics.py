"""Numerics shared across the inference and decode paths."""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import span

#: The reference's infinity stand-in (kw_utils.py:39, phone_recog.cpp:144).
REF_INF = 1e20


def log_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Stable log-softmax with the JAX package's operation order:
    ``x - max - log(sum(exp(x - max)))``."""
    with span("nnam.numerics.log_softmax"):
        m = torch.amax(x, dim=dim, keepdim=True)
        return x - m - torch.log(torch.sum(torch.exp(x - m), dim=dim,
                                           keepdim=True))


def ref_logsum(lp: np.ndarray, axis: int = 0) -> np.ndarray:
    """Bit-faithful twin of the reference ``logsum`` (kw_utils.py:38-43),
    including its NaN -> -1e20 replacement; numpy, host-side (a copy of
    the JAX package's ``ops/numerics.py::ref_logsum``)."""
    mx = np.max(lp, axis=axis).reshape([lp.shape[0], 1])
    lps = mx + np.log(np.sum(np.exp(lp - mx), axis=axis)).reshape(
        [lp.shape[0], 1])
    lps[np.isnan(lps)] = -REF_INF
    return lps
