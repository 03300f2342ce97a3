"""Tracing / profiling utilities.

Counterpart of ``nnacousticmodeling_tpu/utils/profiling.py``:

* ``trace(dir)`` -- context manager around ``torch.profiler.profile``
  (CPU activity, plus CUDA when a card is present) that writes a
  TensorBoard-loadable trace (``tensorboard_trace_handler``) into
  ``dir``; the profile is also yielded, for ``key_averages()``;
* ``Stopwatch`` -- named wall-clock sections with a report.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[object]:
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))
                 ) as prof:
        yield prof


class Stopwatch:
    """Accumulating named timers: ``with sw("decode"): ...``."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(f"{name}: {self.totals[name]:.3f}s "
                         f"({self.counts[name]}x)")
        return "\n".join(lines)
