"""Training traffic: multi-stream truncated BPTT over a corpus of the
configured shape, through the system's training entry, epoch after
epoch.

Parameters (the traffic mix's file): the training and development sets'
``utterances`` and one length distribution (``median``, ``sigma``,
``min_frames``, ``max_frames``; ``inputs.utterance_lengths``, the order
shuffled by the seed), and the stage: ``optimizer``, ``batch``
(streams), ``bprop_len``, ``lr``.

The entry the window drives: ``train.engine.train_network`` on the
kernel route, each update one CUDA graph replay after a direct first
one and the capture, validation on the development set after every
epoch. Set-up holds the first epoch (the direct update, the capture,
the first validation); the window is the whole epochs that follow until
``--seconds`` has passed.

The comparison takes the first three updates of the first epoch, which
go through the window's own call and feed: each update's loss as the
engine records it, the first update's gradient (the optimizer's state
after it), each parameter's change after the third update, as the
fourth finds them, and the first update's logits. It also takes the
first three updates of the window (graph replays on the second epoch's
index block, from the state the first epoch carried over): their losses
against the reference's from the system's own state at the window's
start (params, optimizer state, stream state). It reads them through
the network's ``apply_sequence`` (the first update's logits and the
stream state's tensors) and through wrappers of three of the engine's
names (the optimizer's maker, the stage's epoch buffers, the stage's
update), which change nothing the updates do; set-up checks that each
is there and holds what the comparison reads.
"""

from __future__ import annotations

import contextlib
import sys
import time
from dataclasses import dataclass
from typing import Dict, List
from unittest import mock

import numpy as np
import torch

from benchmark import inputs
from benchmark.common import Outcome, Work, stamp
from benchmark.reference import nets as ref_nets
from benchmark.trace import WINDOW, Trace, session, span

#: more epochs than any window reaches; the epoch hook ends the stage
EPOCHS = 10_000
#: updates the comparison follows
CHECKED = 3
#: a leaf whose reference gradient norm is under this share of the
#: median leaf's moves by round-off alone and is left out of the changes
STILL_LEAF = 1e-3


class _WindowClosed(Exception):
    pass


def corpus_lengths(traffic: dict, n: int, rng) -> np.ndarray:
    return rng.permutation(inputs.utterance_lengths(
        n, traffic["median"], traffic["sigma"], traffic["min_frames"],
        traffic["max_frames"]))


def stream_rows(offsets: np.ndarray, n: int, seed: int, batch: int,
                bprop: int, updates: int, epoch: int = 0) -> np.ndarray:
    """(updates, batch, bprop) frame indices of the first updates of epoch
    ``epoch`` (from 0): the corpus shuffled by whole utterances (numpy's
    generator from the stage's seed, one permutation of the utterances
    an epoch), then ``batch`` streams at offsets ``b * n // batch``, each
    update ``bprop`` consecutive frames a stream (Chainer's
    SequenceShuffleIterator)."""
    rng = np.random.default_rng(seed)
    for _ in range(epoch + 1):
        order = rng.permutation(len(offsets) - 1)
    shuffled = np.concatenate([np.arange(offsets[s], offsets[s + 1])
                               for s in order])
    start = (np.arange(batch) * n) // batch
    steps = np.arange(updates * bprop).reshape(updates, 1, bprop)
    return shuffled[(start[None, :, None] + steps) % n]


class _Watch:
    """What the comparison reads, kept without changing what an update
    does: the optimizer, the per-update loss buffer, the stream state's
    tensors and the first update's logits; after the first and third
    updates the optimizer's state and the parameters; at the window's
    start the system's whole state."""

    #: the engine's names that ``patches`` wraps
    ENGINE_NAMES = ("make_optimizer", "_epoch_buffers", "_Updates")

    def __init__(self, engine, net, dev, t0):
        self.engine, self.net, self.dev, self.t0 = engine, net, dev, t0
        self.opt = None
        self.losses_buf = None
        self.stream_state = None
        self.calls = 0
        self.state1: Dict[str, Dict[str, torch.Tensor]] = {}
        self.params3: Dict[str, torch.Tensor] = {}
        self.losses: List[float] = []
        self.logits = None
        self.start: dict = {}
        self.window_losses = None

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def patches(self):
        watch = self
        engine = self.engine
        missing = [n for n in self.ENGINE_NAMES if not hasattr(engine, n)]
        if missing or not callable(getattr(engine._Updates, "__call__",
                                           None)):
            raise RuntimeError(
                "the training engine's layout changed: the benchmark reads "
                f"the updates through {self.ENGINE_NAMES}; missing "
                f"{missing or ['_Updates.__call__']}")
        real_opt, real_buffers = engine.make_optimizer, engine._epoch_buffers
        real_apply = self.net.apply_sequence

        def make_optimizer(*a, **k):
            watch.opt = real_opt(*a, **k)
            return watch.opt

        def epoch_buffers(*a, **k):
            bufs = real_buffers(*a, **k)
            watch.losses_buf = bufs[2]
            return bufs

        def apply_sequence(xs, state=None, train=False, **kw):
            out = real_apply(xs, state, train, **kw)
            if train and watch.logits is None:
                # the first update, a direct call; the capture and the
                # replays pass the same stream-state tensors
                watch.logits = out[0].detach().clone()
                watch.stream_state = state
            return out

        class Updates(engine._Updates):
            def __call__(self):
                super().__call__()
                if watch.calls < CHECKED:
                    watch.calls += 1
                    watch.after_update()

        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(self.net, "apply_sequence",
                                              apply_sequence))
        stack.enter_context(mock.patch.object(engine, "make_optimizer",
                                              make_optimizer))
        stack.enter_context(mock.patch.object(engine, "_epoch_buffers",
                                              epoch_buffers))
        stack.enter_context(mock.patch.object(engine, "_Updates", Updates))
        return stack

    def after_update(self):
        self._sync()
        stamp(self.t0, f"update {self.calls} done"
              + (" (the capture)" if self.calls == 2 else ""))
        names = dict((id(p), n) for n, p in self.net.named_parameters())
        if self.calls == 1:
            self.state1 = {names[id(p)]: {k: v.detach().clone()
                                          for k, v in st.items()
                                          if torch.is_tensor(v)}
                           for p, st in self.opt.state.items()}
        if self.calls == CHECKED:
            self.params3 = {n: p.detach().clone()
                            for n, p in self.net.named_parameters()}
            self.losses = self.losses_buf[:CHECKED].tolist()

    def check_layout(self, optimizer: str, steps: int) -> None:
        """Set-up's look that every name the comparison reads through
        held what it reads."""
        keys = OPTIMIZER_STATE[optimizer]
        problems = []
        if self.opt is None:
            problems.append("make_optimizer was not called")
        elif any(not set(keys) <= set(st) for st in self.opt.state.values()):
            problems.append(f"the optimizer's state lacks {keys}")
        if self.losses_buf is None or tuple(self.losses_buf.shape) != (
                steps,):
            problems.append("_epoch_buffers gave no (updates,) loss buffer")
        if self.calls != CHECKED:
            problems.append(f"_Updates was called {self.calls} times, not "
                            f"{CHECKED}")
        if self.logits is None or not self.stream_state:
            problems.append("the network's apply_sequence saw no update")
        if problems:
            raise RuntimeError("the training engine's layout changed: "
                               + "; ".join(problems))

    def keep_start(self) -> None:
        """The system's state at the window's start, as the window's first
        update finds it (on the device; a copy, outside the window)."""
        names = dict((id(p), n) for n, p in self.net.named_parameters())
        self.start = {
            "params": {n: p.detach().clone()
                       for n, p in self.net.named_parameters()},
            "slots": {names[id(p)]: {k: v.detach().clone()
                                     for k, v in st.items()
                                     if torch.is_tensor(v)}
                      for p, st in self.opt.state.items()},
            "stream": [tuple(a.detach().clone() for a in layer)
                       for layer in self.stream_state]}

    def keep_window_losses(self) -> None:
        """The window's first updates' losses, on the device, before the
        next epoch overwrites them."""
        self.window_losses = self.losses_buf[:CHECKED].clone()


#: the optimizer's state that the comparison reads, by optimizer
OPTIMIZER_STATE = {"momentumsgd": ("momentum_buffer",),
                   "adam": ("exp_avg", "exp_avg_sq")}


def first_gradient(optimizer: str, state: Dict[str, torch.Tensor]):
    """The gradient of the first update, from the optimizer's state after
    it: momentum SGD's buffer is the gradient; Adam's first moment is
    (1 - beta1) times it."""
    if optimizer == "momentumsgd":
        return state["momentum_buffer"]
    if optimizer == "adam":
        return state["exp_avg"] / 0.1
    raise ValueError(f"unknown optimizer {optimizer!r}")


@dataclass
class Inputs:
    x: np.ndarray               # training features, time-delayed
    y: np.ndarray
    offsets: np.ndarray
    x_dev: np.ndarray           # development set, time-delayed
    y_dev: np.ndarray
    weights: Dict[str, torch.Tensor]
    stage_seed: int             # the engine's seed (shuffle, masks)


def make_inputs(cell, seed: int, dev) -> Inputs:
    """The run's inputs from its seed: the same for the system and the
    reference, and for the control."""
    model, traffic = cell.model, cell.traffic
    s_w, s_x, s_dev, s_order, s_stage = inputs.seeds(seed, 5)
    delay = model["timedelay"]
    rng = np.random.default_rng(s_order)
    x, y, off = inputs.time_delay(*inputs.corpus(
        corpus_lengths(traffic, traffic["utterances"], rng),
        model["in_dim"], model["num_classes"], dev, s_x), delay)
    xv, yv, _ = inputs.time_delay(*inputs.corpus(
        corpus_lengths(traffic, traffic["dev_utterances"], rng),
        model["in_dim"], model["num_classes"], dev, s_dev), delay)
    return Inputs(x, y, off, xv, yv, inputs.model_weights(model, dev, s_w),
                  s_stage)


def run(cell, seed: int, seconds: float, traced: bool, dev, setup_t0: float,
        now=time.time):
    from nnacousticmodeling_tpu_torch import kernels
    from nnacousticmodeling_tpu_torch.models import get_network
    from nnacousticmodeling_tpu_torch.train import (
        TrainConfig, TrainStage, engine, train_network)

    model, traffic = cell.model, cell.traffic
    on_card = dev.type == "cuda"
    bs, bprop = traffic["batch"], traffic["bprop_len"]

    # ---- set-up: data, model ------------------------------------------
    stamp(setup_t0, "torch and the system imported")
    ins = make_inputs(cell, seed, dev)
    x, y, off, weights, s_stage = (ins.x, ins.y, ins.offsets, ins.weights,
                                   ins.stage_seed)
    xv, yv = ins.x_dev, ins.y_dev
    stamp(setup_t0, "inputs made")
    net = get_network(model["network"], model["layers"], [model["units"]],
                      model["num_classes"], dropout=[cell.config["dropout"]],
                      in_dim=model["in_dim"], scan_impl="pallas", device=dev)
    net.load_state_dict(weights)
    stamp(setup_t0, "network built")
    n = len(x)
    steps = max(n // (bs * bprop), 1)
    frames_epoch = steps * bs * bprop
    vsteps = max(len(xv) // bs, 1)

    marks: List[float] = []
    prof_box: list = []
    sess = session(traced)
    window_span = span(WINDOW)

    def hook(stage, epoch):
        if epoch == 1:
            watch.check_layout(traffic["optimizer"], steps)
            watch.keep_start()
        elif epoch == 2:
            watch.keep_window_losses()
        if on_card:
            torch.cuda.synchronize(dev)
        t = now()
        marks.append(t)
        if epoch == 1:
            stamp(setup_t0, "first epoch done (first update, capture, "
                  "validation)")
            kernels.reset_launches()
            prof_box.append(sess.__enter__())
            window_span.__enter__()
        elif t - marks[0] >= seconds:
            window_span.__exit__(None, None, None)
            sess.__exit__(None, None, None)
            raise _WindowClosed

    config = TrainConfig(
        stages=[TrainStage(epoch=EPOCHS, optimizer=traffic["optimizer"],
                           batch_size=bs, lr=traffic["lr"],
                           early_stopping=False)],
        bprop_len=bprop, seed=s_stage, use_validation=True, log=None,
        epoch_hook=hook)
    watch = _Watch(engine, net, dev, setup_t0)
    with watch.patches():
        try:
            train_network(net, x, y, config, offsets=off, x_dev=xv, y_dev=yv,
                          device=dev)
        except _WindowClosed:
            pass
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    launches = dict(kernels.launches)

    epochs = len(marks) - 1
    window = marks[-1] - marks[0]
    metrics = {"train_frames_per_s": epochs * frames_epoch / window,
               "setup_s": marks[0] - setup_t0}
    work = Work(model=model, updates=epochs * steps,
                train_frames=epochs * frames_epoch,
                net_frames=epochs * vsteps * bs,
                rec_calls=epochs * steps,
                extra={"launches": launches, "epochs": epochs})
    if traced:
        work.trace = Trace(prof_box[0])

    # ---- the comparison, the system's state freed first ----------------
    got = {"losses": watch.losses, "params3": watch.params3,
           "grads": {k: first_gradient(traffic["optimizer"], st)
                     for k, st in watch.state1.items()},
           "logits": watch.logits}
    win = {"start": watch.start, "updates_before": steps,
              "losses": (None if watch.window_losses is None
                         else watch.window_losses.tolist())}
    del net, watch
    if on_card:
        torch.cuda.empty_cache()
    rows = stream_rows(off, n, s_stage, bs, bprop, CHECKED)
    compared = compare(model, traffic, ins, rows, got, dev)
    compared["window_loss_gap"] = window_loss_gap(
        model, traffic, ins, stream_rows(off, n, s_stage, bs, bprop, CHECKED,
                                         epoch=1), win, dev)
    return Outcome(metrics=metrics, compared=compared,
                   attempted=epochs * steps, failed=0, work=work,
                   memory_peak_bytes=peak)


def reference_steps(model, traffic, weights, x, y, rows, dev, tf32=False,
                    loss_rows=None, **start):
    batches = [(torch.as_tensor(x[r], device=dev),
                torch.as_tensor(y[r].astype(np.int64), device=dev))
               for r in rows]
    return ref_nets.train_steps(
        model["network"], weights, batches,
        {"name": traffic["optimizer"], "lr": traffic["lr"]}, tf32=tf32,
        loss_rows=loss_rows, **start)


def _reference_start(network: str, optimizer: str, start: dict):
    """The system's state at the window's start in the reference's terms:
    the optimizer's slots by parameter, and each layer's carried state
    (the LSTM's (c, h); the gated nets' h, their second leaf being the
    system's own flag of a fresh state)."""
    slots = {k: [st[n] for n in OPTIMIZER_STATE[optimizer]]
             for k, st in start["slots"].items()}
    stream = [tuple(layer) if network == "lstm" else (layer[0],)
              for layer in start["stream"]]
    return slots, stream


def window_loss_gap(model, traffic, ins: Inputs, rows, win, dev):
    """The largest relative gap of the window's first updates' losses
    from the reference's, which takes the system's state at the window's
    start (params, optimizer state, stream state, the updates made) and
    the window's rows. None where the window kept nothing."""
    if win["losses"] is None or not win["start"]:
        return None
    start = win["start"]
    slots, stream = _reference_start(model["network"], traffic["optimizer"],
                                     start)
    want, _, _, _ = reference_steps(
        model, traffic, start["params"], ins.x, ins.y, rows, dev,
        state=stream, slots=slots, updates_before=win["updates_before"])
    return max(abs(a - b) / abs(b) for a, b in zip(win["losses"], want))


def _norm_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
               keep) -> float:
    """The worst leaf's | |got| - |want| | over the larger of |want| and
    the median leaf's |want|."""
    names = [k for k in want if keep(k)]
    norms = {k: float(want[k].double().norm()) for k in names}
    median = float(np.median(list(norms.values())))
    return max(abs(float(got[k].double().norm()) - norms[k])
               / max(norms[k], median) for k in names)


def compare(model, traffic, ins: Inputs, rows, got, dev) -> Dict[str, float]:
    """The system's first updates (``got``: each update's loss, the first
    update's gradients, the params after the last) against the plain
    reference's at the stated precision: ``loss_gap``, the largest
    relative gap of an update's loss; ``grad_norm_gap``, the worst leaf's
    gap of the first gradient's norm; ``change_norm_gap``, the worst
    leaf's gap of the change's norm after the last update, leaves whose
    reference gradient is under ``STILL_LEAF`` of the median leaf's left
    out; ``logit_gap_start``, the mean |difference| of the first update's
    logits at each stream's first step (from the zero state), which is
    where TF32's error is not yet hidden by the bf16 roundings' (see
    ``serve.START_FRAMES``)."""
    want_losses, want_g, want_p, want_y = reference_steps(
        model, traffic, ins.weights, ins.x, ins.y, rows, dev)
    if (len(got["losses"]) != CHECKED or set(got["grads"]) != set(want_g)
            or got["logits"] is None):
        return {"loss_gap": None, "grad_norm_gap": None,
                "change_norm_gap": None, "logit_gap_start": None}
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(got["losses"], want_losses))
    g_norms = {k: float(v.double().norm()) for k, v in want_g.items()}
    g_median = float(np.median(list(g_norms.values())))
    still = [k for k in g_norms if g_norms[k] < STILL_LEAF * g_median]
    if still:
        print(f"leaves left out of the change: {still}", file=sys.stderr)
    w = ins.weights
    change_got = {k: got["params3"][k] - w[k] for k in w}
    change_want = {k: want_p[k] - w[k] for k in w}
    b, length = rows.shape[1:]
    logits = got["logits"].reshape(b, length, -1)[:, 0]
    return {"loss_gap": loss_gap,
            "grad_norm_gap": _norm_gaps(got["grads"], want_g,
                                        lambda k: True),
            "change_norm_gap": _norm_gaps(change_got, change_want,
                                          lambda k: k not in still),
            "logit_gap_start": float((logits - want_y[:, 0]).abs().double()
                                     .mean())}


def control(cell, seed: int, dev, fault: str = "tf32") -> Dict[str, float]:
    """The control in the system's place, judged as a run is: the
    reference's first updates from the inputs and rows a run with this
    seed takes, with its float32 products in TF32 (``tf32``), or with a
    fault planted (``half_batch``: the loss's mean taken over the first
    half of the streams)."""
    ins = make_inputs(cell, seed, dev)
    tr = cell.traffic
    rows = stream_rows(ins.offsets, len(ins.x), ins.stage_seed, tr["batch"],
                       tr["bprop_len"], CHECKED)
    losses, grads, params, logits = reference_steps(
        cell.model, tr, ins.weights, ins.x, ins.y, rows, dev,
        tf32=fault == "tf32",
        loss_rows=tr["batch"] // 2 if fault == "half_batch" else None)
    return compare(cell.model, tr, ins, rows,
                   {"losses": losses, "grads": grads, "params3": params,
                    "logits": logits}, dev)
