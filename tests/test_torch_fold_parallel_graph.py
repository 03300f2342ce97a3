"""Fold-parallel training's update as a step function of static buffers
(``train/fold_parallel.py``: ``_make_fold_epoch``), called directly: the
plain version of the CUDA graph each update is on the card.

- Bit-identical log lines (every fold's train and validation loss at
  full precision, the fold lists, the compaction lines) and returned
  params to the loop ``train_folds_parallel`` ran before its update
  became a step of static buffers: that loop (``_loop_fold_epoch``
  below, a copy of it) patched into the module. Feed-forward, LSTM on
  both routes (the kernels' plain versions on ``pallas``), GRU,
  ZoneoutLSTM (masks drawn) and PeepholeLSTM; sgd, momentumsgd and adam;
  early-stopping stages under which folds stop and the stacks compact,
  fixed-epoch stages that keep each fold's best-validation params.
- The bookkeeping of the graph with the capture replaced by a fake (the
  card tests in ``test_torch_cuda.py`` capture for real): one capture a
  (stage, fold count), a new one after each compaction and at each stage
  boundary, the active folds' generators alone registered, the old graph
  gone before the next capture, no capture with ``cuda_graph=False`` or
  a mesh, a failed capture raising.
"""

import functools
import re
import weakref
from collections import Counter

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.func import functional_call

from nnacousticmodeling_tpu_torch.decoder.image import make_synthetic_image
from nnacousticmodeling_tpu_torch.models import get_network
from nnacousticmodeling_tpu_torch.parallel.mesh import make_mesh
from nnacousticmodeling_tpu_torch.train import TrainConfig, TrainStage
from nnacousticmodeling_tpu_torch.train import engine, fold_parallel
from nnacousticmodeling_tpu_torch.train.fold_parallel import (
    _fold_seed,
    train_folds_parallel,
)
from nnacousticmodeling_tpu_torch.utils.synthetic import make_synthetic_corpus

K, DIM, CLASSES = 3, 10, 16
# tests/test_torch_fold_parallel.py's schedules: sgd at lr 0.5 stops the
# folds at different epochs
ES_FF = dict(epoch=6, optimizer="sgd", batch_size=8, lr=0.5,
             early_stopping=True)
ES_LSTM = dict(ES_FF, epoch=10)
ES_MOMENTUM = dict(ES_LSTM, optimizer="momentumsgd", lr=0.1)
# adam (lr 1e-3) stops a fold only on the CONFLICT labels below
ES_ADAM = dict(ES_FF, optimizer="adam", epoch=4)
FIXED = dict(epoch=2, optimizer="momentumsgd", batch_size=8, lr=0.05,
             early_stopping=False)
FIXED_ADAM = dict(FIXED, optimizer="adam")
# one gentle epoch before the LSTM's adam stage (from its random init the
# LSTM's dev loss falls in every fold for a while)
WARM = dict(FIXED, epoch=1, lr=0.01)
TIME = re.compile(r" \([0-9.]+s\)")


@pytest.fixture(scope="module")
def corpus():
    img = make_synthetic_image(num_phones=4, num_states=CLASSES, seed=5,
                               tied=False)
    return make_synthetic_corpus(img, dim=DIM, num_train=12, num_dev=4,
                                 num_test=2, noise=0.9, seed=5)


@pytest.fixture
def full_precision(monkeypatch):
    """The per-fold losses are logged through ``np.array2string(a,
    precision=3)``: print them whole instead."""
    orig = np.array2string
    monkeypatch.setattr(np, "array2string", functools.partial(
        lambda a, precision=None, _f=orig: _f(a, precision=9,
                                              max_line_width=10 ** 6)))


def _targets(corpus, labels):
    """The corpus's targets, or with ``labels="conflict"`` fold 2's
    training set (the utterances of folds 0 and 1) all class 1 and the
    rest class 0, against a dev set of class 0: fold 2's dev loss rises
    from its first epoch on while the others' falls, so fold 2 stops."""
    c = corpus.train
    if labels is None:
        return c.targets, corpus.dev.targets
    y = np.zeros_like(c.targets)
    for u in range(c.num_utts):
        if u % K != 2:
            y[c.offsets[u]:c.offsets[u + 1]] = 1
    return y, np.zeros_like(corpus.dev.targets)


def _run(corpus, network, impl, dropout, stages, labels=None, **kw):
    """(log lines without their seconds, K param maps) of one
    ``train_folds_parallel`` run on the CPU, K inits drawn from seed 0."""
    y, y_dev = _targets(corpus, labels)
    net = get_network(network, 1, [16], CLASSES, dropout=dropout,
                      in_dim=DIM, scan_impl=impl, device="cpu")
    logs = []
    params = train_folds_parallel(
        net, corpus.train.data, y, corpus.train.offsets,
        np.arange(corpus.train.num_utts) % K, K,
        TrainConfig(stages=[TrainStage(**s) for s in stages], bprop_len=5,
                    seed=0, log=logs.append),
        x_dev=corpus.dev.data, y_dev=y_dev, **kw)
    return [TIME.sub("", m) for m in logs], params


# ---- bit-identical to the loop train_folds_parallel ran before ------------

def _loop_fold_epoch(net, recurrent, xd, yd, params, opt, states, gens,
                     fold_ids, n_steps, bs, b_loc, L, split, graph):
    """The epoch as ``train_folds_parallel`` ran it before its update
    became a step of static buffers: each update's (k, bs, L) indices a
    slice of the epoch's block, each fold's stream state rebound to its
    forward's detached output, the losses a list of device tensors."""
    names = list(params)

    def update(idx):
        if split is not None:
            idx = split.rows(idx, 1)
        views = {n: p.unbind(0) for n, p in params.items()}
        xb, yb = xd[idx], yd[idx]
        losses = []
        for i, k in enumerate(fold_ids):
            p = {n: views[n][i] for n in names}
            kw = {"train": True, "generator": gens[k]}
            if recurrent:
                logits, st = functional_call(net, p, (xb[i], states[k]), kw)
                states[k] = [tuple(a.detach() for a in layer)
                             for layer in st]
                ce = F.cross_entropy(logits.reshape(b_loc * L, -1),
                                     yb[i].reshape(-1), reduction="none")
                losses.append(ce.reshape(b_loc, L).mean(dim=0).sum())
            else:
                logits = functional_call(net, p, (xb[i],), kw)
                losses.append(F.cross_entropy(logits, yb[i]))
        loss = torch.stack(losses)
        opt.zero_grad(set_to_none=True)
        loss.sum().backward()
        if split is not None:
            split.reduce(params.values())
        opt.step()
        return loss.detach() / L

    def run_epoch(glob):
        rows = glob[torch.from_numpy(fold_ids).to(xd.device)]
        losses = []
        for s in range(n_steps):
            idx = rows[:, s]
            if not recurrent:
                idx = idx.reshape(len(fold_ids), bs * L)[:, :bs]
            losses.append(update(idx))
        return torch.stack(losses).mean(dim=0)

    return run_epoch


@pytest.mark.parametrize("network,impl,dropout,stages,labels,compactions", [
    ("ff", "xla", [0.2], [ES_FF, FIXED], None, 1),
    ("ff", "xla", [0.2], [ES_ADAM, FIXED_ADAM], "conflict", 1),
    ("lstm", "xla", [0.2], [ES_LSTM, FIXED], None, 2),
    ("lstm", "pallas", [0.2], [WARM, ES_ADAM], "conflict", 1),
    ("gru", "xla", [0.2], [ES_MOMENTUM, FIXED_ADAM], None, 1),
    ("zoneoutlstm", "xla", [0.3, 0.2], [ES_LSTM, FIXED_ADAM], None, 2),
    ("peepholelstm", "pallas", [0.2], [ES_MOMENTUM, FIXED], None, 2),
], ids=["ff", "ff-adam", "lstm-xla", "lstm-pallas-adam", "gru",
        "zoneout-masks", "peephole-pallas"])
def test_direct_call_bit_identical_to_loop(monkeypatch, corpus,
                                           full_precision, network, impl,
                                           dropout, stages, labels,
                                           compactions):
    """An early-stopping stage in which folds stop (the stacks compact,
    adam's state carried over by ``_compacted_optimizer``), then a
    fixed-epoch stage: every log line and every fold's params are the old
    loop's, bit for bit; the losses fell."""
    got_logs, got = _run(corpus, network, impl, dropout, stages, labels)
    monkeypatch.setattr(fold_parallel, "_make_fold_epoch", _loop_fold_epoch)
    want_logs, want = _run(corpus, network, impl, dropout, stages, labels)
    assert got_logs == want_logs
    assert sum("compacted" in m for m in got_logs) == compactions, got_logs
    assert any("stage=1 epoch=2 " in m for m in got_logs)
    assert len(got) == len(want) == K
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            assert torch.equal(g[k], v), k
    first = re.search(r"loss=\[(.*?)\]", got_logs[1]).group(1)
    last = re.search(r"loss=\[(.*?)\]", got_logs[-1]).group(1)
    assert np.array(last.split(), float).mean() < np.array(
        first.split(), float).mean()


# ---- the graph's bookkeeping (the capture faked) --------------------------

class _FakeGraph:
    def __init__(self, step, replays=None):
        self.step = step
        self.replays = [0] if replays is None else replays

    def replay(self):
        self.replays[0] += 1
        self.step()


@pytest.fixture
def fake_card(monkeypatch):
    """``train_folds_parallel`` on CPU tensors decides on a graph as it
    would on the card, and each capture is a ``_FakeGraph`` whose replay
    calls the step. Returns the captures: (the registered generators'
    seeds, whether every earlier graph was gone at the capture, the
    graph's replay count)."""
    real = fold_parallel._captures
    monkeypatch.setattr(fold_parallel, "_captures",
                        lambda cuda_graph, dev, mesh: real(
                            cuda_graph, torch.device("cuda"), mesh))
    captures = []
    alive = []

    def fake_capture(step, generator):
        gone = all(ref() is None for ref in alive)
        replays = [0]
        graph = _FakeGraph(step, replays)
        alive.append(weakref.ref(graph))
        captures.append(([g.initial_seed() for g in generator], gone,
                         replays))
        return graph, Counter()

    monkeypatch.setattr(engine, "_capture_update", fake_capture)
    return captures


@pytest.mark.parametrize("network,stages", [
    ("lstm", [ES_LSTM, FIXED]),
    ("ff", [ES_FF, FIXED_ADAM]),
])
def test_one_capture_a_stage_and_fold_count(corpus, fake_card, network,
                                            stages):
    """One capture for each (stage, fold count) that ran an epoch, in
    order: a new one after each compaction and at the stage boundary,
    each registering the generators of the folds it trains and taken
    after the previous graph was dropped; the replays give the direct
    calls' log and params."""
    logs, got = _run(corpus, network, "xla", [0.2], stages)
    segments = []
    for m in logs:
        hit = re.search(r"stage=(\d+) epoch=\d+ folds=\[(.*?)\]", m)
        if hit and (not segments or segments[-1] != hit.groups()):
            segments.append(hit.groups())
    assert len(segments) >= 3 and any("compacted" in m for m in logs)
    assert len(fake_card) == len(segments)
    for (seeds, gone, replays), (_, folds) in zip(fake_card, segments):
        assert seeds == [_fold_seed(0, int(k)) for k in folds.split(",")]
        assert gone and replays[0] > 0
    fake_card.clear()
    want_logs, want = _run(corpus, network, "xla", [0.2], stages,
                           cuda_graph=False)
    assert not fake_card
    assert logs == want_logs
    for g, w in zip(got, want):
        for k, v in w.items():
            assert torch.equal(g[k], v), k


def test_no_capture_without_graph_or_with_a_mesh(corpus, fake_card):
    """Runs that would be captured on the card but for
    ``cuda_graph=False`` or a (one-rank) mesh make direct calls only; the
    same run without either captures once a stage."""
    stages = [dict(ES_FF, epoch=2), dict(FIXED, epoch=1)]
    _run(corpus, "ff", "xla", [0.2], stages, cuda_graph=False)
    _run(corpus, "lstm", "xla", [0.2], stages,
         mesh=make_mesh({"fold": 1, "data": 1}))
    assert fake_card == []
    _run(corpus, "ff", "xla", [0.2], stages)
    assert len(fake_card) == 2


def test_capture_rule():
    """On the card, without a mesh, unless ``cuda_graph=False``."""
    from nnacousticmodeling_tpu_torch.parallel.mesh import Mesh
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert fold_parallel._captures(True, cuda, None)
    assert not fold_parallel._captures(False, cuda, None)
    assert not fold_parallel._captures(True, cuda, Mesh({"fold": 1}))
    assert not fold_parallel._captures(True, cpu, None)


def test_failed_capture_and_replaced_tensor_raise(corpus, fake_card,
                                                  monkeypatch):
    """A capture that fails makes ``train_folds_parallel`` raise, naming
    itself and the cause, with no eager fallback; a parameter replaced
    since the capture raises at the next epoch."""
    def fail(step, generator):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(engine, "_capture_update", fail)
    with pytest.raises(RuntimeError, match="train_folds_parallel: capturing "
                       "the update as a CUDA graph failed.*not permitted"):
        _run(corpus, "lstm", "xla", [0.2], [FIXED])
    p = torch.zeros(3)
    monkeypatch.setattr(engine, "_capture_update",
                        lambda fn, gen: (_FakeGraph(fn), Counter()))
    updates = engine._Updates(lambda: None, [], lambda: [p], graph=True,
                              caller="train_folds_parallel")
    updates()
    updates()
    p = torch.ones(3)               # the tensor the graph trained is gone
    with pytest.raises(RuntimeError, match="train_folds_parallel: a "
                       "parameter or optimizer state tensor was replaced"):
        updates.begin_epoch()
