"""Faults planted in the system's timed path, where a later change could
make them, for the readings that set the comparison's limits
(``control.py --planted``, on the card at a cell's size) and for the
tests that see each come out not correct (``tests/test_bench_faults.py``,
on the CPU at a tiny size). Each is a context manager that patches the
system, or the harness's own step of the timed path, while it is open.

A one-chip cell has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

#: the frame after which ``scan_state_dropped`` restarts the recurrence
DROP_AFTER = 24


# ---- serving ---------------------------------------------------------------

def scan_state_unchanged():
    """``lstm_scan`` returns its initial state and zero hiddens."""
    from nnacousticmodeling_tpu_torch.models import networks

    def scan(proj, wh, c0, h0):
        return (c0, h0), proj.new_zeros(proj.shape[:2] + h0.shape[1:])
    return mock.patch.object(networks, "lstm_scan", scan)


def scan_state_dropped():
    """``lstm_scan`` drops its carried state after frame ``DROP_AFTER``
    and runs on from zeros, as a scan that loses its state between two
    time tiles would: the first frames stay right."""
    from nnacousticmodeling_tpu_torch.models import networks
    real = networks.lstm_scan

    def scan(proj, wh, c0, h0):
        if proj.shape[0] <= DROP_AFTER:
            return real(proj, wh, c0, h0)
        _, hs1 = real(proj[:DROP_AFTER].contiguous(), wh, c0, h0)
        carry, hs2 = real(proj[DROP_AFTER:].contiguous(), wh,
                          torch.zeros_like(c0), torch.zeros_like(h0))
        return carry, torch.cat([hs1, hs2])
    return mock.patch.object(networks, "lstm_scan", scan)


def serve_half_batch():
    """The network runs the first half of a batch's utterances and hands
    their outputs out for the second half too."""
    from nnacousticmodeling_tpu_torch.models import networks
    real = networks.LSTM.apply_sequence

    def apply_sequence(self, xs, state=None, train=False, generator=None):
        half = (xs.shape[0] + 1) // 2
        y, st = real(self, xs[:half], None, train, generator)
        return torch.cat([y, y])[:xs.shape[0]], st
    return mock.patch.object(networks.LSTM, "apply_sequence", apply_sequence)


def serve_answer_altered():
    """The backtrace's first segment of the first utterance names the
    next triphone."""
    from nnacousticmodeling_tpu_torch.decoder import viterbi
    real = viterbi.backtrace

    def backtrace(*args, **kwargs):
        segs, counts = real(*args, **kwargs)
        segs = segs.clone()
        segs[0, 0, 2] += 1
        return segs, counts
    return mock.patch.object(viterbi, "backtrace", backtrace)


def tail_trim_wrong():
    """The time-delay trim zeroes no frame: each utterance's last
    ``timedelay`` posteriors are left as the network gave them."""
    from benchmark import common
    serve = common.generator("serve")

    def trim(lp, lens, delay):
        return lp[:, delay:]
    return mock.patch.object(serve, "delay_trim", trim)


# ---- training --------------------------------------------------------------

def step_state_unchanged():
    """The optimizer's step leaves every parameter as it was."""
    def unchanged(real):
        def step(self, closure=None):
            before = [p.detach().clone() for g in self.param_groups
                      for p in g["params"]]
            out = real(self, closure)
            with torch.no_grad():
                for p, b in zip((p for g in self.param_groups
                                 for p in g["params"]), before):
                    p.copy_(b)
            return out
        return step

    stack = contextlib.ExitStack()
    for opt in (torch.optim.SGD, torch.optim.Adam):
        stack.enter_context(mock.patch.object(opt, "step",
                                              unchanged(opt.step)))
    return stack


def train_half_batch():
    """The loss's mean is taken over the first half of the streams (the
    second half's per-frame losses replaced by the first half's)."""
    from nnacousticmodeling_tpu_torch.train import engine
    real = engine.F.cross_entropy

    class _F:
        def __getattr__(self, name):
            return getattr(torch.nn.functional, name)

        @staticmethod
        def cross_entropy(logits, target, *args, **kwargs):
            ce = real(logits, target, *args, **kwargs)
            if ce.dim() == 0:
                return ce
            half = ce.shape[0] // 2
            return torch.cat([ce[:half], ce[:half]])
    return mock.patch.object(engine, "F", _F())


def train_answer_altered():
    """Each update's recorded loss is 1 % high."""
    from nnacousticmodeling_tpu_torch.train import engine
    real = engine._record

    def record(step_no, losses, accs, loss, acc):
        real(step_no, losses, accs, loss * 1.01, acc)
    return mock.patch.object(engine, "_record", record)


def stale_rows():
    """Every epoch trains on the first epoch's order of the corpus, as an
    engine that uploads the epoch's index block once would: the first
    epoch stays right."""
    from nnacousticmodeling_tpu_torch.train import engine
    real = engine.sentence_shuffle_indices
    first = []

    def shuffle(offsets, n, rng):
        order = real(offsets, n, rng)
        if not first:
            first.append(order)
        return first[0]
    return mock.patch.object(engine, "sentence_shuffle_indices", shuffle)


#: the planted faults of each traffic kind, by name
PLANTED = {
    "serve": {f.__name__: f for f in (
        scan_state_unchanged, scan_state_dropped, serve_half_batch,
        serve_answer_altered, tail_trim_wrong)},
    "train": {f.__name__: f for f in (
        step_state_unchanged, train_half_batch, train_answer_altered,
        stale_rows)},
}
