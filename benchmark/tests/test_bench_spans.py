"""The system's spans in a traced run (``benchmark.spans``), on a made-up
profiler session whose device operations and launches carry
correlation ids: attribution to the innermost span (a graph replay's
kernels to the span around its ``cudaGraphLaunch``), span counts, idle
time in spans, the guard, the readings; and every per-layer metric the
benchmark has reading the same with and without the system's spans."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import common, spans
from benchmark.trace import Trace


class _Event:
    def __init__(self, name, kind, start, end, corr=0):
        self._n, self._k, self._s, self._e, self._c = (name, kind, start,
                                                        end, corr)

    def name(self):
        return self._n

    def activity_type(self):
        return self._k

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def correlation_id(self):
        return self._c


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def _host(name, start, end):
    return _Event(name, "user_annotation", start, end)


def _launch(name, at, corr):
    return _Event(name, "cuda_runtime", at, at + 5, corr)


def _op(name, start, end, corr, kind="kernel"):
    return _Event(name, kind, start, end, corr)


def _serve_events(batches=2, drop=False):
    """``batches`` serving batches 1000 ns apart: a 40-ns input
    projection GEMM, a 10-ns layout copy, a 30-ns output GEMM, a 20-ns
    log-softmax, the Viterbi forward and a 15-ns backtrace, each launched
    in its span inside ``bench.network`` / ``bench.decode``."""
    ev = [_host("bench.window", 0, 1000 * batches + 500)]
    c = 0
    for i in range(batches):
        t = 1000 * i + 100
        ev += [_host("bench.network", t, t + 300),
               _host("nnam.net.input_proj", t, t + 20),
               _host("nnam.net.layout", t + 20, t + 40),
               _host("nnam.net.output", t + 40, t + 60),
               _host("nnam.numerics.log_softmax", t + 60, t + 80),
               _host("bench.decode", t + 300, t + 400),
               _host("nnam.decode.forward", t + 300, t + 340),
               _host("nnam.decode.backtrace", t + 340, t + 380)]
        d = t + 400                          # the device runs behind
        for name, at, length, kind in [
                ("sgemm", t + 5, 40, "kernel"),
                ("Memcpy DtoD", t + 25, 10, "gpu_memcpy"),
                ("sgemm", t + 45, 30, "kernel"),
                ("elementwise_kernel", t + 65, 20, "kernel"),
                ("collapsed_viterbi_cluster_kernel", t + 305, 200, "kernel"),
                ("viterbi_backtrace_kernel", t + 345, 15, "kernel")]:
            c += 1
            ev.append(_op(name, d, d + length, c, kind))
            if not (drop and name == "collapsed_viterbi_cluster_kernel"):
                ev.append(_launch("cudaLaunchKernel", at, c))
            d += length
    return ev


def _serve_work(events, batches=2):
    cell = common.load_cell("lstm_serve_testset")
    return cell, common.Work(
        model=cell.model, trace=spans.SpanTrace(_prof(events)),
        batches=batches, net_frames=1000, rec_calls=batches,
        decode_frames=900, decode_calls=batches, triphones=110592,
        num_states=1909, table_bytes=10 ** 6, extra={"launches": {}})


def test_device_time_goes_to_the_innermost_span():
    _, work = _serve_work(_serve_events())
    tr = work.trace
    assert tr.span_seconds({"nnam.net.input_proj"}) == pytest.approx(80e-9)
    assert tr.span_seconds({"nnam.net.layout"}) == pytest.approx(20e-9)
    assert tr.span_seconds({"nnam.net.output",
                            "nnam.numerics.log_softmax"}) == \
        pytest.approx(100e-9)
    assert tr.span_seconds({"nnam.decode.backtrace"}) == pytest.approx(
        30e-9)
    assert tr.unlaunched_s() == 0
    assert dict(tr.launches_by_span(lambda n: n == "sgemm")) == \
        pytest.approx({"nnam.net.input_proj": 80e-9,
                       "nnam.net.output": 60e-9})
    assert tr.span_count("nnam.decode.forward") == 2


def _train_events(epochs=2, updates=3, idle=50, drop=False):
    """Epochs of ``updates`` graph replays (two kernels a replay, both
    with the replay's correlation id), then validation (a kernel launched
    in ``nnam.net.output`` inside ``nnam.train.validate``, the device
    idle until it comes: 5 ns); ``idle`` ns of the device's idle time at
    each epoch's index upload."""
    ev, c, t = [], 0, 0
    for e in range(epochs):
        start = t
        ev.append(_host("nnam.train.index_upload", t, t + idle))
        c += 1
        ev += [_op("Memcpy HtoD", t + idle, t + idle + 5, c, "gpu_memcpy"),
               _launch("cudaMemcpyAsync", t, c)]
        t += idle + 5
        for u in range(updates):
            c += 1
            ev += [_host("nnam.train.update", t, t + 10),
                   _op("lstm_train_fwd_persistent", t, t + 60, c),
                   _op("sgemm", t + 60, t + 100, c)]
            if not (drop and u == 0):
                ev.append(_launch("cudaGraphLaunch", t + 1, c))
            t += 100
        c += 1
        ev += [_host("nnam.train.validate", t, t + 30),
               _host("nnam.net.output", t + 5, t + 10),
               _op("sgemm", t + 5, t + 30, c),
               _launch("cudaLaunchKernel", t + 6, c)]
        t += 30
        ev.append(_host("nnam.train.epoch", start, t))
    return [_host("bench.window", 0, t)] + ev


def _train_work(events, epochs=2, updates=3):
    cell = common.load_cell("lstm_train_tbptt")
    return cell, common.Work(
        model=cell.model, trace=spans.SpanTrace(_prof(events)),
        updates=epochs * updates, train_frames=10 ** 6, net_frames=1000,
        rec_calls=epochs * updates,
        extra={"launches": {}, "epochs": epochs})


def test_graph_replays_count_to_the_update_and_idle_to_its_span():
    cell, work = _train_work(_train_events())
    tr = work.trace
    assert tr.span_seconds({"nnam.train.update"}) == pytest.approx(600e-9)
    # validation's kernel is launched in nnam.net.output inside it
    assert tr.span_seconds({"nnam.train.validate"}) == 0
    assert tr.span_seconds({"nnam.train.validate"}, innermost=False) == \
        pytest.approx(50e-9)
    assert tr.idle_in({"nnam.train.epoch"}, {"nnam.train.update"}) == \
        pytest.approx(110e-9)
    assert tr.idle_in({"nnam.train.epoch"}, {"nnam.train.validate"}) == \
        pytest.approx(100e-9)
    assert tr.idle_in({"nnam.train.update"}) == 0
    assert dict(tr.idle_gaps()) == pytest.approx(
        {"nnam.train.index_upload": 100e-9, "nnam.train.validate": 10e-9})
    assert tr.span_count("nnam.train.update") == 6
    assert spans.unsound(cell, work) == []


def test_idle_gaps_name_the_system_span_inside_the_harness_span():
    ev = [_host("bench.window", 0, 1000), _host("bench.network", 0, 600),
          _host("nnam.net.layout", 100, 300), _host("bench.wait", 600, 1000),
          _op("k", 0, 100, 1), _op("k", 300, 600, 2)]
    got = dict(spans.SpanTrace(_prof(ev)).idle_gaps())
    assert got == pytest.approx({"nnam.net.layout": 200e-9,
                                 "bench.wait": 400e-9})
    # the harness's own reduction names the same gaps by bench.* alone
    assert dict(Trace(_prof(ev)).idle_gaps()) == pytest.approx(
        {"bench.network": 200e-9, "bench.wait": 400e-9})


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_guard_refuses_dropped_launches(kind):
    if kind == "serve":
        cell, work = _serve_work(_serve_events(drop=True))
    else:
        cell, work = _train_work(_train_events(drop=True))
    assert work.trace.unlaunched_s() > 0
    bad = spans.unsound(cell, work)
    assert len(bad) == 1 and "not in the trace" in bad[0]


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_guard_refuses_counts_that_disagree(kind):
    if kind == "serve":
        cell, work = _serve_work(_serve_events(), batches=3)
    else:
        cell, work = _train_work(_train_events(), updates=4)
    bad = spans.unsound(cell, work)
    assert len(bad) == 1 and "spans in the window" in bad[0]


def test_guard_refuses_a_trace_without_spans():
    cell, work = _serve_work(_serve_events())
    work.trace = Trace(_prof(_serve_events()))
    assert spans.unsound(cell, work)


def test_readings():
    _, work = _serve_work(_serve_events())
    got = {k: f(work) for k, f in spans.READINGS.items()
           if k.startswith("serve.")}
    assert got == pytest.approx({
        "serve.input_proj_ms": 40e-6, "serve.layout_ms": 10e-6,
        "serve.output_ms": 50e-6, "serve.backtrace_ms": 15e-6})
    _, work = _train_work(_train_events())
    got = {k: f(work) for k, f in spans.READINGS.items()
           if k.startswith("train.")}
    assert got == pytest.approx({
        "train.update_ms": 100e-6, "train.validation_ms": 25e-6,
        "train.boundary_idle_ms": 55e-6})


def test_readings_silent_without_the_system_spans():
    """A program with no spans (the parent of this reader): nothing to
    read, and nothing raises."""
    plain = [e for e in _serve_events() if not e.name().startswith("nnam.")]
    _, work = _serve_work(plain)
    assert all(f(work) is None for k, f in spans.READINGS.items()
               if k.startswith("serve."))
    plain = [e for e in _train_events() if not e.name().startswith("nnam.")]
    _, work = _train_work(plain)
    assert all(f(work) is None for k, f in spans.READINGS.items()
               if k.startswith("train."))


@pytest.mark.parametrize("cell_name,make", [
    ("lstm_serve_testset", _serve_events), ("lstm_train_tbptt",
                                            _train_events)])
def test_every_reader_reads_the_same_with_and_without_the_spans(cell_name,
                                                                make):
    events = make()
    plain = [e for e in events if not e.name().startswith("nnam.")]
    cell = common.load_cell(cell_name)

    def values(trace):
        work = common.Work(model=cell.model, trace=trace, batches=2,
                           updates=6, net_frames=1000, train_frames=10 ** 6,
                           rec_calls=2, decode_frames=900, decode_calls=2,
                           triphones=110592, num_states=1909,
                           table_bytes=10 ** 6,
                           extra={"launches": {}, "epochs": 2})
        return {m["name"]: common.metric_reader(m["name"]).read(work)
                for m in cell.per_layer}

    want = values(Trace(_prof(plain)))
    assert any(v is not None for v in want.values())
    for trace in (Trace(_prof(events)), spans.SpanTrace(_prof(events)),
                  spans.SpanTrace(_prof(plain))):
        assert values(trace) == want
        assert (trace.busy_s, trace.ops, trace.spans, trace.top_ops()) == (
            Trace(_prof(plain)).busy_s, Trace(_prof(plain)).ops,
            Trace(_prof(plain)).spans, Trace(_prof(plain)).top_ops())
