"""The traced run's guard against lost launches: the system's own
counter (``kernels.launches``, wrapper calls, graph replays included)
must show each expected kernel exactly as often as the window's batches
or updates need it, and the profiler's trace must hold a whole multiple
of that many device kernels of the same name (a wrapper call launches
one kernel a row chunk). A profiler session that dropped a kernel would
give the per-layer metrics a wrong time, so such a run reports none."""

from __future__ import annotations

from typing import Dict, List, Tuple


def expected(cell, work) -> List[Tuple[str, str, int]]:
    """(counter name, device kernel name, wrapper calls) the window
    needs; counters that must stay at zero have 0 calls."""
    m = cell.model
    layers = m["layers"]
    rec = {"lstm": "lstm", "gru": "gated"}[m["network"]]
    scan = (f"{rec}_scan", f"{rec}_scan_persistent")
    if cell.traffic["kind"] == "serve":
        b = work.batches
        return [(*scan, layers * b),
                ("collapsed_viterbi_forward",
                 "collapsed_viterbi_cluster_kernel", b),
                ("collapsed_viterbi_forward.global",
                 "collapsed_viterbi_kernel", 0),
                ("viterbi_backtrace", "viterbi_backtrace_kernel", b)]
    u = work.updates
    return [(f"{rec}_train_forward", f"{rec}_train_fwd_persistent",
             layers * u),
            (f"{rec}_train_backward", f"{rec}_train_bwd_persistent",
             layers * u),
            (f"{rec}_train_dw", "dw_gemm_kernel", layers * u),
            (*scan, layers * work.extra["epochs"])]


def lost(cell, work) -> List[str]:
    """What does not add up, empty where every count does."""
    counted: Dict[str, int] = work.extra["launches"]
    trace = work.trace
    bad = []
    for counter, kernel, calls in expected(cell, work):
        n = counted.get(counter, 0)
        k = trace.count(lambda name: kernel in name)
        if n != calls:
            bad.append(f"{counter} counted {n}, the window needs {calls}")
        if (calls == 0 and k) or (calls and (k < calls or k % calls)):
            bad.append(f"{kernel} ran {k} times in the trace for {calls} "
                       f"calls")
    return bad
