"""Multi-stream TBPTT index layout.

Behavioral twin of the reference ``SequenceShuffleIterator``
(orcus_chainer_util.py:56-109): the concatenated corpus is re-ordered by
whole utterances (frames stay in order inside each utterance), then B
parallel streams read it at fixed offsets ``i * N // B``. Streams cross
utterance boundaries WITHOUT any state reset — a deliberate quirk the
trained models depend on. Each TBPTT update consumes ``bprop_len``
consecutive frames per stream.

Here the layout is materialized as index arrays consumed by one device
gather per update, instead of per-frame Python iteration. A numpy copy
of the JAX package's ``train/streams.py``: both packages draw the same
minibatches from one seed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def sentence_shuffle_indices(offsets: Optional[np.ndarray], n: int,
                             rng: np.random.Generator) -> np.ndarray:
    """Frame permutation that shuffles whole utterances
    (orcus_chainer_util.py:100-109). With no offsets, identity."""
    if offsets is None:
        return np.arange(n, dtype=np.int64)
    order = rng.permutation(len(offsets) - 1)
    out = np.empty(n, dtype=np.int64)
    pos = 0
    for s in order:
        l = offsets[s + 1] - offsets[s]
        out[pos:pos + l] = np.arange(offsets[s], offsets[s + 1])
        pos += l
    return out


def stream_batch_indices(shuffled_idx: np.ndarray, batch_size: int,
                         start_iter: int, bprop_len: int) -> np.ndarray:
    """(batch, bprop_len) frame indices for one TBPTT update.

    Stream b at update-step t reads
    ``shuffled_idx[(b*N//B + start_iter + t) % N]`` — the reference's
    offset layout (orcus_chainer_util.py:66,94-98).
    """
    n = len(shuffled_idx)
    offsets = (np.arange(batch_size, dtype=np.int64) * n) // batch_size
    steps = start_iter + np.arange(bprop_len, dtype=np.int64)
    pos = (offsets[:, None] + steps[None, :]) % n
    return shuffled_idx[pos]
