#!/usr/bin/env python3
"""Run one cell of the benchmark of ``nnacousticmodeling_tpu_torch``.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the NVIDIA GPUs the cell
asks for. The cell (``BENCHMARK.json``'s workload) names its
configuration, its traffic mix and its own file; the traffic mix's
``kind`` names the generator (``benchmark/traffic/<kind>.py``) that builds
the inputs from the seed, warms up every shape the cell uses, measures
for ``--seconds`` and compares what the timed path produced with the
plain reference (``benchmark/reference``). With ``--trace 0`` the
result line carries the cell's end-to-end metrics; with ``--trace 1``
the window runs under the profiler and the line carries the per-layer
metrics, each read by its own reader (``benchmark/metrics/<name>.py``).

The last line of standard output is the result, a JSON object; the
compared numbers and their limits close standard error. The run exits
non-zero, with no result, when there is no CUDA device or fewer than
the cell needs, when the system cannot be imported, when a traced run
loses a launch, and when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# every cache of the run inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _process_start() -> float:
    """Wall-clock time at which this process started."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(float(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


START = _process_start()


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def execute(workload: str, seed: int, seconds: float, traced: bool,
            device: str = "cuda", cell=None) -> dict:
    """One run of ``workload``; returns the result line's object. The
    tests call it with ``device="cpu"`` and a reduced ``cell``."""
    import torch

    from benchmark import common, launches

    cell = cell or common.load_cell(workload)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    gen = common.generator(cell.traffic["kind"])
    out = gen.run(cell, seed, seconds, traced, dev, START)
    correct, rows = common.judge(out.compared, cell.limits)
    if traced:
        lost = launches.lost(cell, out.work)
        if lost:
            raise RuntimeError("the traced run lost launches: " + "; ".join(
                lost))
        metrics = {}
        for m in cell.per_layer:
            value = common.metric_reader(m["name"]).read(out.work)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.metrics[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": int(cell.entry["chips"]),
        "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": bool(correct), "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics,
              "device": device_info}
    if traced:
        tr = out.work.trace
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["compared"] = {k: {"value": _finite(v["value"]),
                              "limit": v["limit"]} for k, v in rows.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        import torch
        from benchmark import common
        import nnacousticmodeling_tpu_torch  # noqa: F401  (the system)
    except ImportError as e:
        log(f"cannot import the harness or the system under test: {e}")
        return 2
    try:
        cell = common.load_cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        log(f"cannot load the cell {args.workload!r}: {e}")
        return 2
    need = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"the cell needs {need} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" available")
        return 3
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    result = execute(args.workload, args.seed, args.seconds,
                     bool(args.trace))
    found = common.forbidden_modules()
    if found:
        log(f"the measured process loaded {found}: no result")
        return 4
    for name, row in result["compared"].items():
        log(f"compared {name} {row['value']} limit {row['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
