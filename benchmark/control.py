#!/usr/bin/env python3
"""The control of a cell's comparison, on the chip at the cell's size:

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]

For each seed it builds the inputs a run with that seed builds, puts
the plain reference in the system's place with its float32 products in
TF32 (the nearest precision below the stated one), and judges that by
the run's own comparison. With ``--fault half_batch`` (training cells)
the reference in the system's place takes the loss's mean over half of
the streams instead: the readings of that fault. Those read the numbers
that the reference alone can give: not the window's (training's
``window_loss_gap``). With ``--planted <fault>`` (one of
``faults.PLANTED``) it runs the cell itself instead, the fault planted
in the system, for ``--seconds``, and reads every number. It prints each
seed's numbers beside the cell's limits, and one JSON line at the end.
A limit the control does not exceed on some number of every seed leaves
the comparison blind to that step down in precision. The benchmark's
runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(workload: str, seed: int, fault: str = "tf32",
             device: str = "cuda") -> dict:
    import torch

    from benchmark import common
    cell = common.load_cell(workload)
    return common.generator(cell.traffic["kind"]).control(
        cell, seed, torch.device(device), fault)


def planted_readings(workload: str, seed: int, fault: str, seconds: float,
                     device: str = "cuda", cell=None) -> dict:
    """A run of the cell with ``fault`` planted in the system: its
    compared numbers."""
    from benchmark import common, faults, run
    cell = cell or common.load_cell(workload)
    with faults.PLANTED[cell.traffic["kind"]][fault]():
        out = run.execute(workload, seed, seconds, False, device=device,
                          cell=cell)
    return {k: v["value"] for k, v in out["compared"].items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default="tf32",
                    choices=("tf32", "half_batch"))
    ap.add_argument("--planted", default=None,
                    help="a fault of faults.PLANTED, run in the system")
    ap.add_argument("--seconds", type=float, default=2.0,
                    help="the window of a --planted run")
    args = ap.parse_args(argv)
    import torch

    from benchmark import common
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 3
    limits = common.load_cell(args.workload).limits
    fault = args.planted or args.fault
    out = {}
    for seed in args.seeds:
        if args.planted:
            got = planted_readings(args.workload, seed, args.planted,
                                   args.seconds)
        else:
            got = readings(args.workload, seed, args.fault)
        out[seed] = got
        print(f"{fault} seed {seed}: " + ", ".join(
            f"{k} {got.get(k)} (limit {v})" for k, v in limits.items()),
            file=sys.stderr, flush=True)
    print(json.dumps({"workload": args.workload, "fault": fault,
                      "limits": limits, "readings": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
