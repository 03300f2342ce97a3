"""The traced run's reduction (``benchmark.trace``), the lost-launch
guard (``benchmark.launches``) and the per-layer readers, on a made-up
profiler session."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import common, launches
from benchmark.trace import Trace


class _Event:
    def __init__(self, name, kind, start, end):
        self._n, self._k, self._s, self._e = name, kind, start, end

    def name(self):
        return self._n

    def activity_type(self):
        return self._k

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e


def _trace(events):
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    return Trace(prof)


EVENTS = [
    _Event("bench.window", "user_annotation", 1000, 11000),
    _Event("bench.window", "gpu_user_annotation", 1000, 11000),
    _Event("bench.wait", "user_annotation", 5000, 9000),
    _Event("before the window", "kernel", 0, 900),
    _Event("lstm_scan_persistent<float>", "kernel", 1000, 3000),
    _Event("ampere_sgemm", "kernel", 2500, 4000),             # overlaps
    _Event("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 4000, 4500),
    _Event("collapsed_viterbi_cluster_kernel", "kernel", 6000, 8000),
    _Event("viterbi_backtrace_kernel", "kernel", 10000, 12000),  # clipped
    _Event("aten::mm", "cpu_op", 1000, 2000),
]


def test_busy_window_and_gaps():
    tr = _trace(EVENTS)
    assert tr.window_s == pytest.approx(10e-6)
    # busy: [1000, 4500], [6000, 8000], [10000, 11000]
    assert tr.busy_s == pytest.approx(6.5e-6)
    gaps = dict(tr.idle_gaps())
    # gaps [4500, 6000] (its middle inside bench.wait), [8000, 10000]
    assert gaps == pytest.approx({"bench.wait": 1.5e-6,
                                  "outside every span": 2e-6})
    assert tr.count(lambda n: "viterbi" in n) == 2
    assert [n for n, _ in tr.top_ops(2)] == [
        "lstm_scan_persistent<float>", "collapsed_viterbi_cluster_kernel"]


def test_trace_needs_one_window():
    with pytest.raises(RuntimeError):
        _trace(EVENTS[2:])


def _serve_work(trace, launched, batches=1):
    cell = common.load_cell("lstm_serve_testset")
    work = common.Work(model=cell.model, trace=trace, batches=batches,
                       net_frames=1000, rec_calls=batches, decode_frames=900,
                       decode_calls=batches, triphones=110592,
                       num_states=1909, table_bytes=10 ** 6,
                       extra={"launches": launched})
    return cell, work


def _serve_events(scans):
    ev = [_Event("bench.window", "user_annotation", 0, 10 ** 9)]
    ev += [_Event("lstm_scan_persistent<float, true>", "kernel", i * 10,
                  i * 10 + 5) for i in range(scans)]
    ev += [_Event("collapsed_viterbi_cluster_kernel", "kernel", 100, 10 ** 6),
           _Event("viterbi_backtrace_kernel", "kernel", 10 ** 6, 10 ** 6 + 9)]
    return ev


GOOD = {"lstm_scan": 4, "collapsed_viterbi_forward": 1,
        "viterbi_backtrace": 1}


def test_launch_guard_passes_whole_counts():
    cell, work = _serve_work(_trace(_serve_events(4)), GOOD)
    assert launches.lost(cell, work) == []


@pytest.mark.parametrize("scans, counted", [
    (3, GOOD),                                     # the trace lost one
    (4, {**GOOD, "lstm_scan": 3}),                 # a wrapper call fewer
    (4, {**GOOD, "collapsed_viterbi_forward.global": 1}),
])
def test_launch_guard_catches(scans, counted):
    cell, work = _serve_work(_trace(_serve_events(scans)), counted)
    assert launches.lost(cell, work)


def test_readers_read_the_trace_and_stay_silent_without_it():
    cell, work = _serve_work(_trace(_serve_events(4)), GOOD)
    values = {m["name"]: common.metric_reader(m["name"]).read(work)
              for m in cell.per_layer}
    assert 0 < values["serve.viterbi_roofline"] <= 100
    assert 0 < values["serve.rnn_scan_roofline"]
    assert values["serve.stack_ms"] is None          # no stack kernel
    quiet = _trace([_Event("bench.window", "user_annotation", 0, 100)])
    _, work = _serve_work(quiet, GOOD)
    for name in ("serve.viterbi_roofline", "serve.rnn_scan_roofline",
                 "serve.stack_ms"):
        assert common.metric_reader(name).read(work) is None
