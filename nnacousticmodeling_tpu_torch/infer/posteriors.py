"""Batched posterior inference.

Counterpart of ``nnacousticmodeling_tpu/infer/posteriors.py``. Feed-
forward nets (``ff_log_posteriors``, ``:35-59``) run in fixed frame
chunks of 8192; eager PyTorch compiles nothing per shape, so the last
chunk runs at its own length where the JAX package pads it (the rows
are independent, so the values are the same). Recurrent nets
(``rnn_log_posteriors``, ``:62-141``): utterances are bucketed by length
into padded ``(rows, T_bucket, D)`` batches, the remainder group is sized
to ``max(8, next power of two)`` rows, the log-priors ``ap`` are
subtracted before the normalisation (``y -= ap`` then log-softmax, the
reference's evaluate-path order), and ``timedelay`` keeps the
reference's zero tail. ``ensemble_log_posteriors`` (``:144-174``) runs
a ``models.Ensemble`` through either of the two. Every path subtracts
the log-priors ``ap`` before the normalisation.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.numerics import log_softmax


def ff_log_posteriors(
    net,
    x: np.ndarray,
    ap: Optional[np.ndarray] = None,
    chunk: int = 8192,
) -> np.ndarray:
    """(N, D) frames -> (N, C) log posteriors, in ``chunk``-frame chunks
    on ``net``'s device."""
    dev = net.device
    ap_t = (torch.from_numpy(np.asarray(ap, np.float32)).to(dev)
            if ap is not None else None)
    n = x.shape[0]
    outs = []
    with torch.inference_mode():
        for beg in range(0, n, chunk):
            xs = torch.from_numpy(np.ascontiguousarray(
                x[beg:beg + chunk], np.float32)).to(dev)
            y = net.apply(xs)
            if ap_t is not None:
                y = y - ap_t
            outs.append(log_softmax(y, dim=-1).cpu().numpy())
    return np.concatenate(outs, axis=0)


def _buckets(lengths: np.ndarray, bucket_sizes: Sequence[int]):
    """Assign each utterance to the smallest bucket holding it."""
    out = []
    for l in lengths:
        for b in bucket_sizes:
            if l <= b:
                out.append(b)
                break
        else:
            raise ValueError(f"utterance length {l} exceeds largest bucket")
    return np.asarray(out)


def default_buckets(max_len: int) -> List[int]:
    sizes = [128]
    while sizes[-1] < max_len:
        sizes.append(sizes[-1] * 2)
    return sizes


def rnn_log_posteriors(
    net,
    x: np.ndarray,
    offsets: np.ndarray,
    ap: Optional[np.ndarray] = None,
    timedelay: int = 0,
    batch: int = 64,
    bucket_sizes: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Ragged utterances -> concatenated (N, C) log posteriors, computed
    on ``net``'s device.

    With ``timedelay`` k the input of each utterance is edge-padded k
    frames on the right and the first k output frames are dropped; the
    LAST k output rows of each utterance stay 0.0, the reference's quirk
    (predict_folds.py:49-61), reproduced for parity.
    """
    dev = net.device
    lengths = np.diff(offsets)
    num_utts = len(lengths)
    in_lengths = lengths + timedelay
    if bucket_sizes is None:
        bucket_sizes = default_buckets(int(in_lengths.max()))
    assignment = _buckets(in_lengths, bucket_sizes)
    ap_t = (torch.from_numpy(np.asarray(ap, np.float32)).to(dev)
            if ap is not None else None)

    dim = x.shape[1]
    out = [None] * num_utts
    with torch.inference_mode():
        for b in sorted(set(assignment.tolist())):
            utt_ids = np.nonzero(assignment == b)[0]
            for beg in range(0, len(utt_ids), batch):
                ids = utt_ids[beg:beg + batch]
                bs = len(ids)
                rows = min(batch, max(8, 1 << (bs - 1).bit_length()))
                xs = np.zeros((rows, b, dim), dtype=np.float32)
                for row, u in enumerate(ids):
                    frames = x[offsets[u]:offsets[u + 1]]
                    if timedelay > 0:
                        frames = np.pad(frames, ((0, timedelay), (0, 0)),
                                        "edge")
                    xs[row, :frames.shape[0]] = frames
                y, _ = net.apply_sequence(torch.from_numpy(xs).to(dev))
                if ap_t is not None:
                    y = y - ap_t
                y = log_softmax(y, dim=-1).cpu().numpy()
                for row, u in enumerate(ids):
                    o = y[row, timedelay:timedelay + lengths[u]].copy()
                    if timedelay > 0:
                        o[max(lengths[u] - timedelay, 0):] = 0.0
                    out[u] = o
    return np.concatenate(out, axis=0)


class _EnsembleNet:
    """An ensemble and its params behind the network interface that
    ``ff_log_posteriors`` and ``rnn_log_posteriors`` call."""

    def __init__(self, ensemble, params):
        self.ensemble, self.params = ensemble, params
        self.device = ensemble.device

    def apply(self, x):
        return self.ensemble.apply(self.params, x)

    def apply_sequence(self, xs, state=None):
        return self.ensemble.apply_sequence(self.params, xs, state)


def ensemble_log_posteriors(
    ensemble,
    params,
    x: np.ndarray,
    offsets: Optional[np.ndarray] = None,
    ap: Optional[np.ndarray] = None,
    timedelay: int = 0,
    batch: int = 64,
    chunk: int = 8192,
) -> np.ndarray:
    """Posteriors of a ``models.Ensemble`` (master, folds and RPL): each
    batch or chunk runs the master and the K fold nets as K + 1 passes,
    combines their logits and applies the head."""
    net = _EnsembleNet(ensemble, params)
    if ensemble.is_recurrent:
        if offsets is None:
            raise ValueError("recurrent ensemble needs offsets")
        return rnn_log_posteriors(net, x, offsets, ap=ap,
                                  timedelay=timedelay, batch=batch)
    return ff_log_posteriors(net, x, ap=ap, chunk=chunk)
