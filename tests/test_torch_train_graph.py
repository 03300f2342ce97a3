"""The training engine's update as a step function of static buffers
(``train/engine.py``: ``_Updates``), called directly: the plain version
of the CUDA graph each update is on the card.

- Against JAX ``train_network`` for every ``dispatch`` value (the JAX
  ``per_step`` and ``scan`` programs, ``auto`` resolving to ``scan``;
  the port takes the same direct call for all three), on the nets,
  routes, dtypes and optimizers of the one-card trainer, from one
  ``save_pytree`` init, dropout 0 and zoneout ratios 0 (the frameworks
  draw different masks) and one seed (the same minibatches). Tolerances
  are those the existing engine tests state for the same net and route:
  ``test_torch_train.py`` (the float32 step loop rtol 1e-5 / atol 1e-5,
  the kernels' plain versions 1e-4 / 5e-3, bf16 1e-3 / 1e-2),
  ``test_torch_gated_train.py`` (bf16 GRU 5e-3 / 1e-2),
  ``test_torch_peephole_train.py`` (the peephole kernels' plain versions
  1e-3 / 5e-3) and ``test_torch_ff.py`` (MLP and TDNN float32 1e-4 /
  1e-3, bf16 1e-2 / 1e-2), as losses rtol / params atol. The JAX
  engine's bf16 TDNN update raises (its conv's operands differ in
  dtype), so the bf16 TDNN is held to the port's old loop only.
- Bit-identical params and history to the loop the engine ran before
  its update became a step of static buffers: that loop's epoch
  (``_loop_ff_stage``, ``_loop_rnn_stage`` below, a copy of it) patched
  into the engine, with dropout and zoneout masks drawn.
- Bit-exact resume, mid-stage and at a stage boundary, the stream state
  restored into the stage's static tensors.
- ``_Updates``' bookkeeping with the capture replaced by a fake (the
  card tests in ``test_torch_cuda.py`` capture for real): one direct
  call, one capture, a replay a later update, replayed launches
  counted, a replaced parameter or a failed capture raising.
"""

import dataclasses
from collections import Counter

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nnacousticmodeling_tpu.decoder import make_synthetic_image
from nnacousticmodeling_tpu.models import get_network as j_get_network
from nnacousticmodeling_tpu.train import TrainConfig as JTrainConfig
from nnacousticmodeling_tpu.train import TrainStage as JTrainStage
from nnacousticmodeling_tpu.train import load_pytree as j_load
from nnacousticmodeling_tpu.train import train_network as j_train_network
from nnacousticmodeling_tpu.train.checkpoint import _path_str
from nnacousticmodeling_tpu.train.checkpoint import save_pytree as j_save
from nnacousticmodeling_tpu.utils.synthetic import make_synthetic_corpus
from nnacousticmodeling_tpu_torch import kernels
from nnacousticmodeling_tpu_torch.models import get_network
from nnacousticmodeling_tpu_torch.train import (
    TrainConfig,
    TrainStage,
    load_jax_params,
    sentence_shuffle_indices,
    stream_batch_indices,
    train_network,
)
from nnacousticmodeling_tpu_torch.train import engine

MOMENTUM = dict(epoch=2, optimizer="momentumsgd", batch_size=4, lr=1e-2,
                early_stopping=False)
ADAM = dict(epoch=2, optimizer="adam", batch_size=4, lr=1e-2,
            early_stopping=False)
FF_MOMENTUM = dict(MOMENTUM, batch_size=32)
FF_ADAM = dict(ADAM, batch_size=32)
# (name, layers, units, kw of get_network, feature width)
NETS = {
    "ff": ("ff", 2, [32], {}, 10),
    "tdnn": ("tdnn", 2, [16, 16], dict(tdnn_ksize=(3, 3)), 50),
    "gru": ("gru", 2, [16], {}, 10),
    "lstm": ("lstm", 2, [16], {}, 10),
    "zoneoutlstm": ("zoneoutlstm", 2, [16], {}, 10),
    "peepholelstm": ("peepholelstm", 2, [16], {}, 10),
    "mgrurelur": ("mgrurelur", 1, [16], {}, 10),
}


@pytest.fixture(scope="module")
def corpus():
    img = make_synthetic_image(num_phones=4, num_states=16, seed=3,
                               tied=False)
    return make_synthetic_corpus(img, dim=10, num_train=8, num_dev=4,
                                 num_test=2, noise=0.4, seed=3)


def _x(corpus, net):
    """The corpus's features at the net's input width (the TDNN's spliced
    window of 5 frames of 10)."""
    d = NETS[net][4]
    reps = d // 10
    return [np.tile(s.data, (1, reps)) for s in (corpus.train, corpus.dev)]


def _port_net(net, dropout=(0.0,), impl="xla"):
    name, layers, units, kw, d = NETS[net]
    return get_network(name, layers, units, 16, dropout=list(dropout),
                       in_dim=d, scan_impl=impl, device="cpu", **kw)


def _port_run(corpus, net, stages, impl="xla", dropout=(0.0,), init=None,
              **kw):
    x, x_dev = _x(corpus, net)
    recurrent = NETS[net][0] not in ("ff", "tdnn")
    cfg = TrainConfig(stages=[TrainStage(**s) for s in stages], bprop_len=5,
                      seed=0, log=None, **kw)
    return train_network(_port_net(net, dropout, impl), x,
                         corpus.train.targets, cfg,
                         offsets=corpus.train.offsets if recurrent else None,
                         x_dev=x_dev, y_dev=corpus.dev.targets,
                         init_params=init, device="cpu")


# ---- against JAX train_network, every dispatch value ---------------------

@pytest.mark.parametrize(
    "net,impl,dtype,stages,dispatch,zero,loss_rtol,param_atol", [
        ("ff", "xla", "float32", [FF_MOMENTUM], "per_step", [0.0], 1e-4,
         1e-3),
        ("ff", "xla", "float32", [FF_ADAM], "scan", [0.0], 1e-4, 1e-3),
        ("ff", "xla", "bfloat16", [FF_ADAM], "auto", [0.0], 1e-2, 1e-2),
        ("gru", "xla", "float32", [ADAM], "per_step", [0.0], 1e-5, 1e-5),
        ("gru", "xla", "float32", [ADAM], "scan", [0.0], 1e-5, 1e-5),
        ("gru", "xla", "float32", [ADAM], "auto", [0.0], 1e-5, 1e-5),
        ("gru", "pallas", "bfloat16", [MOMENTUM], "scan", [0.0], 5e-3, 1e-2),
        ("lstm", "pallas", "float32", [MOMENTUM, ADAM], "auto", [0.0], 1e-4,
         5e-3),
        ("lstm", "pallas", "bfloat16", [MOMENTUM], "per_step", [0.0], 1e-3,
         1e-2),
        ("zoneoutlstm", "pallas", "float32", [MOMENTUM, ADAM], "scan",
         [0.0, 0.0], 1e-5, 1e-5),
        ("peepholelstm", "pallas", "float32", [MOMENTUM], "per_step", [0.0],
         1e-3, 5e-3),
        ("tdnn", "xla", "float32", [FF_MOMENTUM], "auto", [0.0], 1e-4, 1e-3),
        ("tdnn", "xla", "float32", [FF_ADAM], "per_step", [0.0], 1e-4, 1e-3),
    ], ids=["ff-per_step", "ff-adam-scan", "ff-bf16-auto", "gru-per_step",
            "gru-scan", "gru-auto", "gru-pallas-bf16-scan",
            "lstm-pallas-auto", "lstm-pallas-bf16-per_step",
            "zoneout-pallas-scan", "peephole-pallas-per_step", "tdnn-auto",
            "tdnn-adam-per_step"])
def test_direct_call_matches_jax_every_dispatch(
        tmp_path, corpus, net, impl, dtype, stages, dispatch, zero,
        loss_rtol, param_atol):
    """Per-epoch train and validation losses and the final params of the
    port's direct-call step against the JAX engine's ``dispatch`` program
    (mirrors ``tests/test_train.py``'s dispatch test, ``ff`` and ``gru``
    with offsets, and widens it to the other nets)."""
    name, layers, units, kw, d = NETS[net]
    jnet = dataclasses.replace(
        j_get_network(name, layers, units, 16, dropout=zero, **kw),
        scan_impl=impl) if name not in ("ff", "tdnn") else j_get_network(
            name, layers, units, 16, dropout=zero, **kw)
    init_path = tmp_path / "init.npz"
    j_save(str(init_path), jnet.init(jax.random.PRNGKey(0), d))
    x, x_dev = _x(corpus, net)
    recurrent = name not in ("ff", "tdnn")
    want = j_train_network(
        jnet, x, corpus.train.targets,
        JTrainConfig(stages=[JTrainStage(**s) for s in stages], bprop_len=5,
                     seed=0, log=None, compute_dtype=dtype,
                     dispatch=dispatch),
        offsets=corpus.train.offsets if recurrent else None, x_dev=x_dev,
        y_dev=corpus.dev.targets,
        init_params=j_load(str(init_path), jnet.init(jax.random.PRNGKey(1),
                                                     d)))
    got = _port_run(corpus, net, stages, impl, zero,
                    init=load_jax_params(init_path, device="cpu"),
                    compute_dtype=dtype, dispatch=dispatch)
    assert [(h["stage"], h["epoch"]) for h in got.history] == \
        [(h["stage"], h["epoch"]) for h in want.history]
    for hp, hj in zip(got.history, want.history):
        assert set(hp) == set(hj)
        for k in ("main/loss", "validation/main/loss"):
            np.testing.assert_allclose(hp[k], hj[k], rtol=loss_rtol,
                                       err_msg=k)
    flat = jax.tree_util.tree_flatten_with_path(want.params)[0]
    assert len(flat) == len(got.params)
    for path, leaf in flat:
        key = _path_str(path).replace("/", ".")
        np.testing.assert_allclose(got.params[key].numpy(), np.asarray(leaf),
                                   atol=param_atol, rtol=0, err_msg=key)


# ---- bit-identical to the loop the engine ran before ---------------------

_STAGE_FF = engine._make_ff_stage
_STAGE_RNN = engine._make_rnn_stage


def _loop_ff_stage(net, opt, xd, yd, offsets, config, bs, val, apply_fn,
                   eval_cache, generator, split=None, graph=False):
    """The feed-forward epoch as the engine ran it before its update
    became a step of static buffers: each minibatch's indices a row of a
    fresh device block, the losses a list of device scalars. Validation
    is the engine's own."""
    _, evaluate = _STAGE_FF(net, opt, xd, yd, offsets, config, bs, val,
                            apply_fn, eval_cache, generator)
    dt = engine._compute_dtype(config)
    model = net if dt is None else engine.HalfPrecisionNet(net, dt)
    n = int(xd.shape[0])
    steps = max(n // bs, 1)

    def update(idx):
        xb, yb = xd[idx], yd[idx]
        logits = model.apply(xb, train=True, generator=generator)
        loss = F.cross_entropy(logits, yb)
        acc = (logits.argmax(-1) == yb).float().mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach(), acc

    def run_epoch(state, rng_np):
        if config.shuffle_sequences:
            idx = stream_batch_indices(
                sentence_shuffle_indices(offsets, n, rng_np), bs, 0, steps).T
        else:
            idx = rng_np.permutation(n)[:steps * bs].reshape(steps, bs)
        idx_dev = torch.from_numpy(np.ascontiguousarray(idx)).to(xd.device)
        losses, accs = [], []
        for s in range(steps):
            loss, acc = update(idx_dev[s])
            losses.append(loss)
            accs.append(acc)
        return (None, float(torch.stack(losses).mean()),
                float(torch.stack(accs).mean()))

    return run_epoch, evaluate


def _loop_rnn_stage(net, opt, xd, yd, offsets, config, bs, val, eval_cache,
                    generator, split=None, graph=False):
    """The TBPTT epoch as the engine ran it before: the state a fresh
    detached tensor each update."""
    _, evaluate, _ = _STAGE_RNN(net, opt, xd, yd, offsets, config, bs, val,
                                eval_cache, generator)
    L = config.bprop_len
    n = int(xd.shape[0])
    dt = engine._compute_dtype(config)
    model = net if dt is None else engine.HalfPrecisionNet(net, dt)

    def update(state, idx):
        flat = idx.reshape(-1)
        xb = xd[flat].reshape(bs, L, -1)
        yb = yd[flat].reshape(bs, L)
        logits, new_state = model.apply_sequence(xb, state, train=True,
                                                 generator=generator)
        loss = F.cross_entropy(logits.reshape(bs * L, -1), yb.reshape(-1),
                               reduction="none").reshape(bs, L)
        total = loss.mean(dim=0).sum()
        acc = (logits.argmax(-1) == yb).float().mean()
        opt.zero_grad(set_to_none=True)
        total.backward()
        opt.step()
        new_state = [tuple(a.detach() for a in layer) for layer in new_state]
        return new_state, total.detach() / L, acc

    steps = max(n // (bs * L), 1)

    def run_epoch(state, rng_np):
        shuffled = sentence_shuffle_indices(offsets, n, rng_np)
        idx_all = stream_batch_indices(shuffled, bs, 0, steps * L
                                       ).T.reshape(steps, L, bs
                                                   ).transpose(0, 2, 1)
        idx_dev = torch.from_numpy(np.ascontiguousarray(idx_all)).to(
            xd.device)
        losses, accs = [], []
        for s in range(steps):
            state, loss, acc = update(state, idx_dev[s])
            losses.append(loss)
            accs.append(acc)
        return (state, float(torch.stack(losses).mean()),
                float(torch.stack(accs).mean()))

    return run_epoch, evaluate, model.init_state(bs)


@pytest.mark.parametrize("net,impl,dropout,dtype,kw", [
    ("ff", "xla", [0.2], "float32", {}),
    ("ff", "xla", [0.2], "bfloat16", dict(shuffle_sequences=True)),
    ("tdnn", "xla", [0.2], "float32", {}),
    ("tdnn", "xla", [0.2], "bfloat16", {}),
    ("lstm", "pallas", [0.2], "float32", {}),
    ("lstm", "pallas", [0.2], "bfloat16", {}),
    ("gru", "xla", [0.2], "float32", {}),
    ("mgrurelur", "pallas", [0.2], "float32", {}),
    ("zoneoutlstm", "xla", [0.3, 0.2], "float32", {}),
    ("peepholelstm", "pallas", [0.2], "float32", {}),
], ids=["ff", "ff-bf16-streams", "tdnn", "tdnn-bf16", "lstm-pallas",
        "lstm-pallas-bf16", "gru", "mgrurelur-pallas", "zoneout-masks",
        "peephole-pallas"])
def test_direct_call_bit_identical_to_loop(monkeypatch, corpus, net, impl,
                                           dropout, dtype, kw):
    """A momentum and an adam stage with validation, dropout (zoneout)
    masks drawn: the history's losses and accuracies and the final
    params are the old loop's, bit for bit."""
    stages = ([FF_MOMENTUM, FF_ADAM] if net in ("ff", "tdnn")
              else [MOMENTUM, ADAM])
    got = _port_run(corpus, net, stages, impl, dropout, compute_dtype=dtype,
                    **kw)
    monkeypatch.setattr(engine, "_make_ff_stage", _loop_ff_stage)
    monkeypatch.setattr(engine, "_make_rnn_stage", _loop_rnn_stage)
    want = _port_run(corpus, net, stages, impl, dropout, compute_dtype=dtype,
                     **kw)
    assert len(got.history) == len(want.history) == 4
    for hg, hw in zip(got.history, want.history):
        for k in ("stage", "epoch", "main/loss", "main/accuracy",
                  "validation/main/loss", "validation/main/accuracy"):
            assert hg[k] == hw[k], k
    assert got.params.keys() == want.params.keys()
    for k, v in want.params.items():
        assert torch.equal(got.params[k], v), k
    assert got.history[-1]["main/loss"] < got.history[0]["main/loss"]


# ---- resume through the static buffers -----------------------------------

class _Crash(Exception):
    pass


@pytest.mark.parametrize("net,impl,dropout,dtype,crash", [
    ("gru", "xla", [0.2], "float32", (0, 1)),
    ("gru", "pallas", [0.2], "bfloat16", (0, 2)),
    ("zoneoutlstm", "xla", [0.3, 0.2], "float32", (0, 1)),
    ("zoneoutlstm", "xla", [0.3, 0.2], "float32", (0, 2)),
    ("ff", "xla", [0.2], "float32", (0, 1)),
], ids=["gru-mid_stage", "gru-bf16-stage_boundary", "zoneout-mid_stage",
        "zoneout-stage_boundary", "ff-mid_stage"])
def test_resume_through_static_buffers(tmp_path, corpus, net, impl, dropout,
                                       dtype, crash):
    """A run killed after an epoch and resumed from its snapshot makes
    the uninterrupted run's remaining epochs and final params exactly:
    the optimizer state, the generator and the stream state (written into
    the stage's static tensors) as they were."""
    stages = ([FF_MOMENTUM, FF_ADAM] if net == "ff" else [MOMENTUM, ADAM])

    def run(snap, resume, hook=None):
        return _port_run(corpus, net, stages, impl, dropout,
                         compute_dtype=dtype, snapshot_path=snap,
                         resume_snapshot=resume, epoch_hook=hook)

    ref = run(str(tmp_path / "ref.npz"), False)

    def hook(stage, epoch):
        if (stage, epoch) == crash:
            raise _Crash

    snap = str(tmp_path / "snap.npz")
    with pytest.raises(_Crash):
        run(snap, False, hook)
    res = run(snap, True)
    done = len(ref.history) - len(res.history)
    assert done == crash[1]
    for h_res, h_ref in zip(res.history, ref.history[done:]):
        for k in ("stage", "epoch", "main/loss", "validation/main/loss"):
            assert h_res[k] == h_ref[k], k
    for k in ref.params:
        assert torch.equal(res.params[k], ref.params[k]), k


# ---- _Updates' bookkeeping (the capture faked) ---------------------------

class _FakeGraph:
    def __init__(self, step):
        self.step = step
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.step()


def test_launch_counts_held_apart_under_capture():
    kernels.reset_launches()
    kernels.launches["a"] += 1
    with kernels.capturing() as made:
        kernels.launches["a"] += 2
        kernels.launches["b"] += 1
    assert made == Counter(a=2, b=1)
    assert kernels.launches == Counter(a=1)
    kernels.replayed(made)
    kernels.replayed(made)
    assert kernels.launches == Counter(a=5, b=2)
    kernels.reset_launches()


def test_updates_direct_call_then_capture_then_replays(monkeypatch):
    """With ``graph`` the first update is a direct call, the second
    captures the step once, and it and every later update is one replay,
    which counts the captured launches; a single update captures nothing;
    without ``graph`` every update is a direct call."""
    p = torch.zeros(3)
    calls = []
    graphs = []

    def step():
        calls.append(1)
        p.add_(1)

    def fake_capture(fn, generator):
        with kernels.capturing() as made:
            kernels.launches["k"] += 2      # the wrapper calls of one step
        graphs.append(_FakeGraph(fn))
        return graphs[-1], made

    monkeypatch.setattr(engine, "_capture_update", fake_capture)
    kernels.reset_launches()
    updates = engine._Updates(step, None, lambda: [p], graph=True)
    for _ in range(4):
        updates()
    assert len(graphs) == 1 and graphs[0].replays == 3
    assert len(calls) == 4 and torch.equal(p, torch.full((3,), 4.0))
    assert kernels.launches == Counter(k=6)
    updates.begin_epoch()
    single = engine._Updates(step, None, lambda: [p], graph=True)
    single()
    direct = engine._Updates(step, None, lambda: [p], graph=False)
    direct()
    direct()
    assert len(graphs) == 1 and len(calls) == 7
    kernels.reset_launches()


def test_updates_raise_on_replaced_tensor_and_failed_capture(monkeypatch):
    p = torch.nn.Parameter(torch.zeros(3))
    monkeypatch.setattr(engine, "_capture_update",
                        lambda fn, gen: (_FakeGraph(fn), Counter()))
    updates = engine._Updates(lambda: None, None, lambda: [p], graph=True)
    updates()
    updates()                       # captured here
    p.data = torch.ones(3)          # rebinds the storage the graph reads
    with pytest.raises(RuntimeError, match="replaced since the update was "
                                           "captured"):
        updates.begin_epoch()

    def fail(fn, gen):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(engine, "_capture_update", fail)
    updates = engine._Updates(lambda: None, None, lambda: [p], graph=True)
    updates()
    with pytest.raises(RuntimeError, match="capturing the update as a CUDA "
                                           "graph failed.*not permitted"):
        updates()
