"""Target time-delay shifting for recurrent training.

Behavioral twin of ``scripts/util/orcus_util.py:13-43``: with delay k > 0
each utterance's inputs are edge-padded k frames on the right and its
targets k frames on the left (so the net sees k future frames before
committing to a label); utterance lengths grow by k and offsets are
rebuilt. k < 0 shifts the whole dataset instead. Vectorized (no
per-utterance Python copy loop for the common path sizes). A numpy copy
of the JAX package's ``ops/timedelay.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def apply_time_delay(
    x: np.ndarray,
    y: Optional[np.ndarray],
    offsets: Optional[np.ndarray],
    timedelay: int,
) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    if timedelay == 0:
        return x, y, offsets
    if timedelay < 0:
        # shift the dataset as a whole (orcus_util.py:14-24)
        x_ = np.pad(x, ((0, -timedelay), (0, 0)), "edge")
        y_ = np.pad(y, (-timedelay, 0), "edge") if y is not None else None
        offsets_ = None
        if offsets is not None:
            offsets_ = offsets.copy()
            offsets_[-1] = len(x)
        return x_, y_, offsets_

    # per-utterance shift (orcus_util.py:25-42)
    if offsets is None:
        raise ValueError("positive timedelay requires utterance offsets")
    num_utts = len(offsets) - 1
    lengths = np.diff(offsets)
    new_len = int(x.shape[0] + num_utts * timedelay)
    x_ = np.empty((new_len, x.shape[1]), dtype=np.float32)
    y_ = np.empty(new_len, dtype=np.int32) if y is not None else None
    offsets_ = np.empty_like(offsets)
    ptr = 0
    for u in range(num_utts):
        beg, end = offsets[u], offsets[u + 1]
        l = lengths[u]
        offsets_[u] = ptr
        x_[ptr:ptr + l] = x[beg:end]
        x_[ptr + l:ptr + l + timedelay] = x[end - 1]          # edge-pad right
        if y is not None:
            y_[ptr:ptr + timedelay] = y[beg]                   # edge-pad left
            y_[ptr + timedelay:ptr + l + timedelay] = y[beg:end]
        ptr += l + timedelay
    offsets_[-1] = ptr
    return x_, y_, offsets_
