"""The system's own spans in a traced run, and the device time each
launched.

The system names its layers with ``record_function`` spans called
``nnam.*`` (``nnacousticmodeling_tpu_torch/utils/profiling.py``). In
the profiler's session every device operation (kernel, copy, fill)
carries a correlation id, and so does the host call that launched it
(``cudaLaunchKernel``, ``cudaGraphLaunch``, ``cudaMemcpyAsync``, ...):
the launch lies inside the span of the layer that made it. A replayed
CUDA graph's kernels carry the id of its ``cudaGraphLaunch``, so they
count to the span around the replay.

``SpanTrace`` is ``Trace`` with that kept: what ``Trace`` holds and
answers stays as it is (``ops``, ``spans``, ``busy_s``, ``seconds``,
``count``, ``top_ops``), and it adds device seconds by span
(``span_seconds``), spans counted in the window (``span_count``), idle
time in and out of spans (``idle_in``) and launches lost from the trace
(``unlaunched_s``); ``idle_gaps`` names a gap after the innermost span
among the harness's ``bench.*`` and the system's ``nnam.*``.

``unsound`` is the guard that goes with them (the companion of
``launches.lost``) and ``READINGS`` the per-layer readings made from
them, each None where the trace holds nothing to read.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Optional, Tuple

from benchmark.trace import DEVICE_ACTIVITIES, Trace, _kind

PREFIX = "nnam."
#: host calls that launch device work, by name (CUDA's ``cuda*`` and
#: ``cu*`` entry points; PyTorch 2.11 with CUDA 12.8 lists them as
#: ``cpu_op`` events, with the correlation ids of what they launched)
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC",
            "cudaLaunchCooperativeKernel", "cudaGraphLaunch",
            "cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy",
            "cuLaunchKernel", "cuLaunchKernelEx")
#: the share of the window's device time whose launch may be missing
LOST_SHARE = 0.01
OUTSIDE = "outside every span"


def _corr(ev) -> Optional[int]:
    get = getattr(ev, "correlation_id", None)
    c = get() if get is not None else None
    return c or None


def _launch(name: str) -> bool:
    return any(name == n or name.startswith(n + "_") for n in LAUNCHES)


def _enclosing(spans: List[Tuple[str, int, int]], times: Iterable[int]
               ) -> Dict[int, Tuple[str, ...]]:
    """Each time's enclosing spans, outermost first (spans properly
    nested, as one thread makes them)."""
    order = sorted(spans, key=lambda s: (s[1], -s[2]))
    out, stack, i = {}, [], 0
    for t in sorted(set(times)):
        while i < len(order) and order[i][1] <= t:
            s = order[i]
            while stack and stack[-1][2] <= s[1]:
                stack.pop()
            stack.append(s)
            i += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        out[t] = tuple(s[0] for s in stack)
    return out


class SpanTrace(Trace):
    def __init__(self, prof):
        super().__init__(prof)
        events = list(prof.profiler.kineto_results.events())
        corr_ops: List[Tuple[str, int, int, Optional[int]]] = []
        launched: Dict[int, Tuple[int, str]] = {}
        nnam: List[Tuple[str, int, int]] = []
        for ev in events:
            kind = _kind(ev)
            if kind in DEVICE_ACTIVITIES:
                if ev.end_ns() > self.t0 and ev.start_ns() < self.t1:
                    corr_ops.append((ev.name(), ev.start_ns(), ev.end_ns(),
                                     _corr(ev)))
            elif kind == "gpu_user_annotation":
                continue
            elif ev.name().startswith(PREFIX):
                nnam.append((ev.name(), ev.start_ns(), ev.end_ns()))
            elif _launch(ev.name()):
                c = _corr(ev)
                if c is not None:
                    launched[c] = (ev.start_ns(), f"{kind} {ev.name()}")
        #: the system's spans, (name, start, end), the window's and not
        self.nnam = sorted(nnam, key=lambda s: s[1])
        #: the window's device operations, (name, start, end, launch
        #: time or None where the trace holds no launch of it)
        self.launched_ops = [(n, a, b, launched[c][0] if c in launched
                              else None) for n, a, b, c in corr_ops]
        #: the launches of the window's operations, by activity and name
        self.launch_names = Counter(launched[c][1] for *_, c in corr_ops
                                    if c in launched)
        self._around = _enclosing(self.nnam, (
            t for *_, t in self.launched_ops if t is not None))

    # -- by span --------------------------------------------------------
    def launched_in(self, t: Optional[int]) -> Tuple[str, ...]:
        """The system's spans around a launch time, outermost first."""
        return () if t is None else self._around.get(t, ())

    def span_seconds(self, names, innermost: bool = True) -> float:
        """Device seconds of the window's operations launched inside a
        span of ``names``: the innermost span around the launch
        (``innermost``), or any of them."""
        names = set(names)
        total = 0
        for _, a, b, t in self.launched_ops:
            around = self.launched_in(t)
            if around and (around[-1] in names if innermost
                           else names.intersection(around)):
                total += b - a
        return total / 1e9

    def span_count(self, name: str) -> int:
        """Spans of ``name`` whose interval lies inside the window."""
        return sum(1 for n, a, b in self.nnam
                   if n == name and a >= self.t0 and b <= self.t1)

    def unlaunched_s(self) -> float:
        """Device seconds of the window's operations whose launch the
        trace does not hold."""
        return sum(b - a for _, a, b, t in self.launched_ops
                   if t is None) / 1e9

    def launches_by_span(self, keep, k: int = 10) -> List[list]:
        """Device seconds of the operations ``keep`` takes (by name),
        summed by the innermost system span around their launch."""
        by: Counter = Counter()
        for n, a, b, t in self.launched_ops:
            if keep(n):
                around = self.launched_in(t)
                by[around[-1] if around else OUTSIDE] += b - a
        return [[n, ns / 1e9] for n, ns in by.most_common(k)]

    # -- idle time ------------------------------------------------------
    def _gaps(self) -> List[Tuple[int, int]]:
        gaps, edge = [], self.t0
        for a, b in self._busy_intervals():
            if a > edge:
                gaps.append((edge, a))
            edge = max(edge, b)
        if self.t1 > edge:
            gaps.append((edge, self.t1))
        return gaps

    def idle_in(self, inside, outside=()) -> float:
        """Device-idle seconds of the window whose gap's middle lies in a
        system span of ``inside`` and in none of ``outside``."""
        inside, outside = set(inside), set(outside)
        gaps = self._gaps()
        around = _enclosing(self.nnam, ((a + b) // 2 for a, b in gaps))
        total = 0
        for a, b in gaps:
            at = set(around[(a + b) // 2])
            if at & inside and not at & outside:
                total += b - a
        return total / 1e9

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The window's idle device time, summed by the innermost span of
        the harness's or the system's the host was in at each gap's
        middle ("outside every span" where none)."""
        spans = self.spans + [s for s in self.nnam
                              if s[2] > self.t0 and s[1] < self.t1]
        gaps = self._gaps()
        around = _enclosing(spans, ((a + b) // 2 for a, b in gaps))
        by: Counter = Counter()
        for a, b in gaps:
            names = around[(a + b) // 2]
            by[names[-1] if names else OUTSIDE] += b - a
        return [[n, ns / 1e9] for n, ns in by.most_common(k)]


# ---------------------------------------------------------------------------
# the guard and the readings
# ---------------------------------------------------------------------------

def unsound(cell, work) -> List[str]:
    """Why the system's spans cannot be read in this run, empty where
    they can: the launches of more than ``LOST_SHARE`` of the window's
    device time missing from the trace, or a span count that disagrees
    with the harness's own (serving: one ``nnam.decode.forward`` a
    batch; training: one ``nnam.train.update`` an update and one
    ``nnam.train.epoch`` an epoch)."""
    tr = work.trace
    if not isinstance(tr, SpanTrace):
        return ["the trace keeps no spans of the system"]
    bad = []
    device = tr.seconds(lambda n: True)
    lost = tr.unlaunched_s()
    if device <= 0 or lost > LOST_SHARE * device:
        bad.append(f"launches of {lost:.6f} s of {device:.6f} s of device "
                   f"time are not in the trace")
    if cell.traffic["kind"] == "serve":
        want = {"nnam.decode.forward": work.batches}
    else:
        want = {"nnam.train.update": work.updates,
                "nnam.train.epoch": work.extra["epochs"]}
    for name, n in want.items():
        got = tr.span_count(name)
        if got != n:
            bad.append(f"{got} {name} spans in the window for {n}")
    return bad


def _per(seconds: float, n: int) -> Optional[float]:
    """Milliseconds each of ``n``; None where nothing was read."""
    return 1e3 * seconds / n if seconds and n else None


def _serve(names):
    return lambda work: _per(work.trace.span_seconds(names), work.batches)


def _boundary_idle(work) -> Optional[float]:
    tr, epochs = work.trace, work.extra.get("epochs", 0)
    if not epochs or tr.span_count("nnam.train.epoch") == 0:
        return None
    return 1e3 * tr.idle_in({"nnam.train.epoch"},
                            {"nnam.train.update"}) / epochs


READINGS = {
    # device ms a serving batch launched in the stack's spans
    "serve.input_proj_ms": _serve({"nnam.net.input_proj"}),
    "serve.layout_ms": _serve({"nnam.net.layout"}),
    "serve.output_ms": _serve({"nnam.net.output",
                               "nnam.numerics.log_softmax"}),
    "serve.backtrace_ms": _serve({"nnam.decode.backtrace"}),
    # device ms an update (the graph replays), validation's device ms an
    # epoch, and the device's idle ms an epoch at the epoch's host work
    "train.update_ms": lambda work: _per(
        work.trace.span_seconds({"nnam.train.update"}), work.updates),
    "train.validation_ms": lambda work: _per(
        work.trace.span_seconds({"nnam.train.validate"}, innermost=False),
        work.extra.get("epochs", 0)),
    "train.boundary_idle_ms": _boundary_idle,
}

