"""The port's named spans (``utils/profiling.py::span``) on the CPU.

In a ``torch.profiler`` session: the training engine's spans nest as an
epoch holds them, one ``nnam.train.epoch`` an epoch and one
``nnam.train.update`` an update, with no engine span inside an update;
the network stack's spans come once a layer (input projection, two
layout copies) and once a call (output layer); each decode makes one
forward and one backtrace span, whichever backend runs; a new pack
factor's tables and an ``nvcc`` run (faked) make one span each, the
first time only; ``trace(dir)``'s file names them. Outside a session a
span enters no profiler op. With the spans on, outputs, losses and
params are those of a run with every span a null context. The engine's epoch clock: device seconds between
two CUDA events on the card, resolved by ``_finalize_history`` under
``defer_metrics``; the host clock's floats on the CPU.
"""

import contextlib
import json
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nnacousticmodeling_tpu_torch import kernels
from nnacousticmodeling_tpu_torch.decoder.image import make_synthetic_image
from nnacousticmodeling_tpu_torch.decoder.viterbi import (
    TIME_PACK, ViterbiDecoder,
)
from nnacousticmodeling_tpu_torch.models import get_network
from nnacousticmodeling_tpu_torch.ops.numerics import log_softmax
from nnacousticmodeling_tpu_torch.train import (
    TrainConfig, TrainStage, engine, train_network,
)
from nnacousticmodeling_tpu_torch.utils import profiling

LAYERS, UNITS, CLASSES, DIM = 2, 8, 5, 3
EPOCHS, BS, L = 2, 4, 5


def _corpus(seed=0, n=240):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, DIM)).astype(np.float32)
    y = rng.integers(0, CLASSES, n)
    return x, y, np.array([0, 50, 130, 190, n])


def _train(network, **kw):
    """A tiny two-epoch stage with validation; (result, updates)."""
    net = get_network(network, LAYERS, [UNITS], CLASSES, in_dim=DIM,
                      scan_impl="pallas", device="cpu")
    x, y, off = _corpus()
    cfg = TrainConfig(stages=[TrainStage(
        epoch=EPOCHS, optimizer="momentumsgd", batch_size=BS, lr=0.05,
        early_stopping=False)], bprop_len=L, log=None, **kw)
    res = train_network(net, x, y, cfg, offsets=off, x_dev=x[:60],
                        y_dev=y[:60], device="cpu", cuda_graph=False)
    recurrent = getattr(net, "is_recurrent", False)
    steps = len(x) // (BS * L) if recurrent else len(x) // BS
    return net, res, EPOCHS * steps


def _spans(prof):
    """The session's ``nnam.*`` host spans, (name, start, end), in
    start order."""
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("nnam.")), key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _innermost_parent(span, spans):
    around = [s for s in spans if s is not span and _inside(span, s)]
    return min(around, key=lambda s: s[2] - s[1])[0] if around else None


def _session():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.mark.parametrize("network", ["lstm", "ff"])
def test_engine_spans_nest_as_an_epoch_holds_them(network):
    with _session() as prof:
        _, res, updates = _train(network)
    spans = _spans(prof)
    count = Counter(s[0] for s in spans)
    assert count["nnam.train.epoch"] == EPOCHS == len(res.history)
    assert count["nnam.train.update"] == updates
    for name in ("nnam.train.shuffle", "nnam.train.index_upload",
                 "nnam.train.epoch_metrics", "nnam.train.validate"):
        assert count[name] == EPOCHS, name
    assert 1 <= count["nnam.train.best_copy"] <= EPOCHS
    assert count["nnam.train.capture"] == 0       # no graph on the CPU
    epochs = [s for s in spans if s[0] == "nnam.train.epoch"]
    for s in spans:
        if s[0].startswith("nnam.train.") and s[0] != "nnam.train.epoch":
            # every engine span in an epoch, none inside an update
            assert _innermost_parent(s, spans) == "nnam.train.epoch", s[0]
    for e in epochs:
        assert sum(s[0] == "nnam.train.validate" and _inside(s, e)
                   for s in spans) == 1
    assert all(s[0].startswith("nnam.") for s in spans)


def test_network_spans_once_a_layer():
    with _session() as prof:
        net, res, updates = _train("lstm")
    count = Counter(s[0] for s in _spans(prof))
    calls = updates + EPOCHS            # one apply_sequence an update, and
    assert count["nnam.net.output"] == calls      # one a validation
    assert count["nnam.net.input_proj"] == LAYERS * calls
    assert count["nnam.net.layout"] == 2 * LAYERS * calls
    assert count["nnam.numerics.log_softmax"] == 0


def _image():
    return make_synthetic_image(num_phones=4, num_states=14, seed=6,
                                pdf_tied_transitions=True)


def _lp(seed=1, utts=3, t=9, states=14):
    rng = np.random.default_rng(seed)
    lp = np.log(rng.dirichlet(np.ones(states), size=(utts, t)))
    return torch.from_numpy(lp.astype(np.float32))


@pytest.mark.parametrize("backend,fn", [
    ("collapsed", "decode_arrays_fn"), ("pallas", "decode_arrays_fn"),
    ("xla", "decode_arrays_fn"), ("collapsed", "decode_fn")])
def test_a_decode_makes_one_forward_and_one_backtrace(backend, fn):
    dec = ViterbiDecoder(_image(), backend=backend, pip=5.0, lmw=1.5,
                         device="cpu")
    decode = getattr(dec, fn)()
    lens = torch.tensor([9, 4, 7], dtype=torch.int32)
    with _session() as prof:
        decode(_lp(), lens)
    spans = _spans(prof)
    assert Counter(s[0] for s in spans) == {"nnam.decode.forward": 1,
                                            "nnam.decode.backtrace": 1}
    fwd, back = spans
    assert fwd[0] == "nnam.decode.forward" and fwd[2] <= back[1]


def test_one_time_work_gets_a_span_once():
    """A new pack factor's collapsed tables and an ``nvcc`` run (faked)
    are spans where they happen, and absent once done."""
    dec = ViterbiDecoder(_image(), pip=5.0, lmw=1.5, device="cpu")
    decode = dec.decode_arrays_fn()
    with _session() as prof:
        decode(_lp(), torch.tensor([9, 4, 7], dtype=torch.int32))
        decode(_lp(utts=1, t=TIME_PACK),
               torch.tensor([TIME_PACK], dtype=torch.int32))
    spans = [s[0] for s in _spans(prof)]
    assert spans.count("nnam.decode.tables") == 1
    assert spans.index("nnam.decode.tables") == 2    # the long decode's


def test_kernel_build_span(monkeypatch, tmp_path):
    class Nvcc:
        def __init__(self, cmd, **kw):
            self.out, self.returncode = Path(cmd[cmd.index("-o") + 1]), 0

        def communicate(self):
            self.out.write_bytes(b"")
            return "report", None

    monkeypatch.setattr(kernels, "library_path",
                        lambda name: tmp_path / f"lib{name}.so")
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernels.subprocess, "Popen", Nvcc)
    with _session() as prof:
        assert kernels.build(["lstm_scan"]) == {"lstm_scan": "report"}
        assert kernels.build(["lstm_scan"]) == {}        # built: no nvcc
    assert [s[0] for s in _spans(prof)] == ["nnam.kernels.build"]


def test_spans_enter_no_profiler_op_without_a_session(monkeypatch):
    enter = torch.ops.profiler._record_function_enter_new

    def refuse(name, *a, **k):
        # PyTorch's own ranges (the optimizer's) enter it regardless
        if name.startswith("nnam."):
            raise AssertionError(f"{name} entered a profiler op")
        return enter(name, *a, **k)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        refuse)
    with pytest.raises(AssertionError):     # the patch is the one used
        with torch.profiler.record_function("nnam.check"):
            pass
    _train("lstm")
    dec = ViterbiDecoder(_image(), pip=5.0, lmw=1.5, device="cpu")
    dec.decode_arrays_fn()(_lp(), torch.tensor([9, 4, 7], dtype=torch.int32))
    log_softmax(torch.zeros(2, 3))


def test_trace_file_names_the_spans(tmp_path):
    net = get_network("lstm", LAYERS, [UNITS], CLASSES, in_dim=DIM,
                      scan_impl="pallas", device="cpu")
    dec = ViterbiDecoder(_image(), pip=5.0, lmw=1.5, device="cpu")
    with profiling.trace(str(tmp_path)), torch.inference_mode():
        y, _ = net.apply_sequence(torch.zeros(3, 9, DIM))
        dec.decode_arrays_fn()(log_softmax(_lp()),
                               torch.tensor([9, 4, 7], dtype=torch.int32))
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in
             json.loads(files[0].read_text())["traceEvents"]}
    assert {"nnam.net.input_proj", "nnam.net.layout", "nnam.net.output",
            "nnam.numerics.log_softmax", "nnam.decode.forward",
            "nnam.decode.backtrace"} <= names


def _everything(decoder_seed=1):
    """A tiny training run, a serving pass and a decode: the values."""
    net, res, _ = _train("lstm")
    with torch.inference_mode():
        y, state = net.apply_sequence(torch.from_numpy(_corpus(3)[0][:54]
                                                       .reshape(2, 27, DIM)))
        lp = log_softmax(y)
    dec = ViterbiDecoder(_image(), pip=5.0, lmw=1.5, device="cpu")
    segs, counts = dec.decode_arrays_fn()(_lp(decoder_seed),
                                          torch.tensor([9, 4, 7],
                                                       dtype=torch.int32))
    hist = [{k: v for k, v in h.items() if k != "elapsed_time"}
            for h in res.history]
    return {"history": hist, "params": res.params, "lp": lp,
            "state": [a for layer in state for a in layer], "segs": segs,
            "counts": counts}


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
    elif torch.is_tensor(a):
        assert torch.equal(a, b)
    else:
        assert a == b


def test_spans_change_no_result(monkeypatch):
    with _session() as prof:
        on = _everything()
    assert _spans(prof)
    real = profiling.span
    for mod in list(sys.modules.values()):
        if (getattr(mod, "__name__", "").startswith(
                "nnacousticmodeling_tpu_torch")
                and getattr(mod, "span", None) is real):
            monkeypatch.setattr(mod, "span",
                                lambda name: contextlib.nullcontext())
    with _session() as prof:
        nulled = _everything()
    assert not _spans(prof)
    _same(on, nulled)


class _FakeEvent:
    def __init__(self, ms):
        self.ms, self.synced = ms, False

    def synchronize(self):
        self.synced = True

    def elapsed_time(self, end):
        assert end.synced
        return end.ms - self.ms


def test_epoch_clock_deferred_floats_and_finalized():
    _, res, _ = _train("lstm", defer_metrics=True)
    assert all(isinstance(h["elapsed_time"], float) and h["elapsed_time"] > 0
               for h in res.history)
    history = [{"elapsed_time": engine._DeviceSeconds(_FakeEvent(2.0),
                                                      _FakeEvent(1502.0)),
                "main/loss": torch.tensor(0.5)}]
    engine._finalize_history(history)
    assert history == [{"elapsed_time": 1.5, "main/loss": 0.5}]
