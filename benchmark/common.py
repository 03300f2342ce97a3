"""What every traffic generator shares: the cell a run measures, its files
found by name, the compared numbers and the result line."""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names the measured process must never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "nnacousticmodeling_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with the files it names: the
    configuration's (``configs/``), the traffic mix's (``traffic/<mix>
    .json``, whose ``kind`` names the generator ``traffic/<kind>.py``) and
    the cell's own (``workloads/<name>.json``: the comparison's limits)."""
    name: str
    entry: dict
    config: dict
    traffic: dict
    workload: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def limits(self) -> Dict[str, float]:
        return self.workload["limits"]


def load_cell(name: str) -> Cell:
    bench = load_json(ROOT / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of "
                       f"{sorted(entries)}")
    entry = entries[name]
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])

    def reports(metric):
        return "workloads" not in metric or name in metric["workloads"]

    return Cell(
        name=name, entry=entry, config=load_json(ROOT / config["file"]),
        traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        workload=load_json(HERE / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if reports(m)],
        per_layer=[m for m in bench["per_layer"] if reports(m)])


def load_module(path: Path, name: str):
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def generator(kind: str):
    return load_module(HERE / "traffic" / f"{kind}.py",
                       f"bench_traffic_{kind}")


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py",
                       "bench_metric_" + name.replace(".", "_"))


def stamp(t0: float, what: str) -> None:
    """Log how far set-up has come, seconds since ``t0``, on stderr."""
    import time
    print(f"set-up {time.time() - t0:8.2f} s: {what}", file=sys.stderr,
          flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


@dataclass
class Work:
    """What a run did in its window, for the per-layer metrics: counts of
    batches, updates and frames, and the traced session."""
    model: dict
    trace: Any = None
    batches: int = 0
    updates: int = 0
    net_frames: int = 0          # network input frames, forward
    train_frames: int = 0        # training frames (updates x rows x steps)
    rec_calls: int = 0           # recurrent calls a layer
    decode_frames: int = 0
    decode_calls: int = 0
    triphones: int = 0
    num_states: int = 0
    table_bytes: int = 0
    extra: dict = field(default_factory=dict)


@dataclass
class Outcome:
    """A generator's result: ``metrics`` by name (end to end), the compared
    numbers, requests attempted and failed, and the window's work."""
    metrics: Dict[str, float]
    compared: Dict[str, float]
    attempted: int
    failed: int
    work: Work
    memory_peak_bytes: int = 0


def judge(compared: Dict[str, float], limits: Dict[str, float]):
    """``correct`` (every number present, finite and within its limit)
    and the numbers beside their limits, in the limits' order."""
    rows = {}
    ok = True
    for name, limit in limits.items():
        value = compared.get(name)
        good = (value is not None and math.isfinite(value)
                and value <= limit)
        ok = ok and good
        rows[name] = {"value": value, "limit": limit}
    return ok, rows
