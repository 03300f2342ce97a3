"""The traced run: a ``torch.profiler`` session over the measured window
and its reduction to what the per-layer metrics read.

The harness marks the window and the calls it makes into each layer
with ``record_function`` spans named ``bench.*``. After the session,
``Trace`` holds the device operations (kernels, copies and fills, each
with its name, start and end) and those spans, all on the profiler's
clock, and answers: the device's busy time inside the window (the union
of its operations, overlaps counted once), device seconds by kernel
name, launches by name, and the window's idle gaps, each put down to
the innermost ``bench.*`` span the host was in at the gap's middle.
"""

from __future__ import annotations

import contextlib
from collections import Counter, defaultdict
from typing import Callable, Dict, List, Optional, Tuple

WINDOW = "bench.window"
#: profiler activity kinds that are work on the device
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def span(name: str):
    """A host span in the traced run (a no-op outside a session)."""
    import torch
    return torch.profiler.record_function(name)


def session(enabled: bool):
    """The profiler over CPU and CUDA activity, or nothing."""
    if not enabled:
        return contextlib.nullcontext(None)
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _kind(ev) -> str:
    try:
        return ev.activity_type()
    except AttributeError:       # older builds: device events are kernels
        from torch.autograd import DeviceType
        if ev.device_type() == DeviceType.CUDA:
            return "gpu_user_annotation" if ev.is_user_annotation() \
                else "kernel"
        return "cpu_op"


class Trace:
    def __init__(self, prof):
        ops: List[Tuple[str, int, int]] = []
        spans: List[Tuple[str, int, int]] = []
        for ev in prof.profiler.kineto_results.events():
            kind = _kind(ev)
            if kind in DEVICE_ACTIVITIES:
                ops.append((ev.name(), ev.start_ns(), ev.end_ns()))
            elif ev.name().startswith("bench.") and kind != \
                    "gpu_user_annotation":
                spans.append((ev.name(), ev.start_ns(), ev.end_ns()))
        windows = [s for s in spans if s[0] == WINDOW]
        if len(windows) != 1:
            raise RuntimeError(f"the trace holds {len(windows)} "
                               f"'{WINDOW}' spans, not one")
        _, self.t0, self.t1 = windows[0]
        self.ops = sorted((o for o in ops if o[2] > self.t0
                           and o[1] < self.t1), key=lambda o: o[1])
        self.spans = [s for s in spans if s[0] != WINDOW]

    # -- sizes ----------------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def _busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for _, a, b in self.ops:
            a, b = max(a, self.t0), min(b, self.t1)
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy_intervals()) / 1e9

    # -- by name --------------------------------------------------------
    def seconds(self, keep: Callable[[str], bool]) -> float:
        """Device seconds of the operations whose name ``keep`` takes."""
        return sum(b - a for n, a, b in self.ops if keep(n)) / 1e9

    def count(self, keep: Callable[[str], bool]) -> int:
        return sum(1 for n, _, _ in self.ops if keep(n))

    def top_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, int] = defaultdict(int)
        for n, a, b in self.ops:
            by[n] += b - a
        return [[n, ns / 1e9] for n, ns in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The window's idle device time, summed by the innermost
        ``bench.*`` span the host was in at each gap's middle ("outside
        every span" where none)."""
        gaps, edge = [], self.t0
        for a, b in self._busy_intervals():
            if a > edge:
                gaps.append((edge, a))
            edge = max(edge, b)
        if self.t1 > edge:
            gaps.append((edge, self.t1))
        by: Counter = Counter()
        spans = sorted(self.spans, key=lambda s: s[1])
        nxt, active = 0, []
        for a, b in gaps:                       # in time order
            mid = (a + b) // 2
            while nxt < len(spans) and spans[nxt][1] <= mid:
                active.append(spans[nxt])
                nxt += 1
            active = [s for s in active if s[2] > mid]
            inner: Optional[Tuple[str, int, int]] = (
                max(active, key=lambda s: s[1]) if active else None)
            by[inner[0] if inner else "outside every span"] += b - a
        return [[n, ns / 1e9] for n, ns in by.most_common(k)]
