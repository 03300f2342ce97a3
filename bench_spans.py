#!/usr/bin/env python3
"""Traced runs of the benchmark's cells read by the port's own spans.

    python3 bench_spans.py --workload <cell> --seed <n> [--seed <n> ...] \
        [--seconds 20] [--out <dir>]

from the root of a checkout, on a card. Each seed is one traced run of
the cell through its traffic generator (``benchmark/traffic``), as
``benchmark/run.py --trace 1`` makes it, with the window's profile kept
as a ``benchmark.spans.SpanTrace`` instead of a ``Trace``: the device
operations with their launches and the port's ``nnam.*`` spans. A run
prints one JSON line (with ``--out``, also ``<dir>/<cell>_<seed>.json``):
the run's own end-to-end numbers (the traced rate), whether it was
correct, the launch guard and the span guard, the cell's per-layer
metrics as the benchmark reads them, the readings made from the spans
(``benchmark.spans.READINGS``), the span counts, the idle time by span,
and the network stack's device time (``benchmark.layers.stack``) and its
element-wise kernels' by the span that launched them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def measure(workload: str, seed: int, seconds: float, device: str = "cuda",
            cell=None) -> dict:
    import torch

    from benchmark import common, launches, layers, spans

    cell = cell or common.load_cell(workload)
    dev = torch.device(device)
    gen = common.generator(cell.traffic["kind"])
    real = gen.Trace
    gen.Trace = spans.SpanTrace
    try:
        out = gen.run(cell, seed, seconds, True, dev, time.time())
    finally:
        gen.Trace = real
    work, tr = out.work, out.work.trace
    correct, _ = common.judge(out.compared, cell.limits)
    per_layer = {m["name"]: common.metric_reader(m["name"]).read(work)
                 for m in cell.per_layer}
    kind = "serve." if cell.traffic["kind"] == "serve" else "train."
    counts = Counter(n for n, a, b in tr.nnam if a >= tr.t0 and b <= tr.t1)
    return {
        "workload": workload, "seed": seed, "correct": bool(correct),
        "end_to_end": out.metrics, "batches": work.batches,
        "updates": work.updates, "epochs": work.extra.get("epochs"),
        "window_s": tr.window_s, "busy_s": tr.busy_s,
        "launch_guard": launches.lost(cell, work),
        "span_guard": spans.unsound(cell, work),
        "unlaunched_s": tr.unlaunched_s(),
        "launch_names": dict(tr.launch_names),
        "per_layer": per_layer,
        "readings": {k: f(work) for k, f in spans.READINGS.items()
                     if k.startswith(kind)},
        "span_counts": dict(counts),
        "idle_gaps": tr.idle_gaps(20),
        "device_by_span": tr.launches_by_span(lambda n: True, 20),
        "stack_by_span": tr.launches_by_span(layers.stack, 20),
        "elementwise_by_span": {
            name: tr.launches_by_span(lambda n, name=name: n == name)
            for name, _ in tr.top_ops(40) if "elementwise_kernel" in name},
        "top_ops": tr.top_ops(15),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", help="a directory for each run's line")
    args = ap.parse_args(argv)
    out = Path(args.out) if args.out else None
    if out:
        out.mkdir(parents=True, exist_ok=True)
    for seed in args.seed:
        line = json.dumps(measure(args.workload, seed, args.seconds))
        if out:
            (out / f"{args.workload}_{seed}.json").write_text(line + "\n")
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
