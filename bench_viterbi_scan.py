#!/usr/bin/env python3
"""The scan kernel's two routes on one NVIDIA card, at chip_smoke.py's
phase-23 shape: 128 utterances of 512 frames of seeded Dirichlet
posteriors (seed 1) on the synthetic 48-phone 1909-pdf untied image and
on its ``full_context=False`` twin.

    python3 bench_viterbi_scan.py

For each image, exact and with beam 2.0: the cluster route
(``viterbi_scan_cluster_kernel``, the plan's 16-block clusters) and the
device-memory route (``route="global"``), held bit-equal to each other,
timed in turns (cluster, device memory, device memory, cluster; CUDA
events, 3 calls after a warm-up call) and by device time (one call under
the profiler), with the co-resident clusters. Prints one line per row
with the card's name and power limit.
"""

import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
U, T, PHONES, CLASSES, BEAM, REPS = 128, 512, 48, 1909, 2.0, 3
KERNELS = {None: "viterbi_scan_cluster_kernel",
           "global": "viterbi_scan_kernel"}


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("bench_viterbi_scan.py needs a CUDA card")
    sys.path.insert(0, str(HERE))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nnacousticmodeling_tpu_torch.decoder import viterbi_scan as vscan
    from nnacousticmodeling_tpu_torch.decoder.image import (
        make_synthetic_image)
    from nnacousticmodeling_tpu_torch.decoder.viterbi import ViterbiDecoder

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    rng = np.random.default_rng(1)
    lp = torch.from_numpy(np.log(rng.dirichlet(
        np.ones(CLASSES), size=(U, T))).astype(np.float32)).cuda()

    def events_ms(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / REPS

    def device_ms(fn, name):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda._sleep(1)    # a kernel behind it: the last one counts
            torch.cuda.synchronize()
        found = [ev for ev in prof.key_averages()
                 if getattr(ev, "device_type", None) == DeviceType.CUDA
                 and name in ev.key]
        if len(found) != 1 or found[0].count != 1:
            return None
        return found[0].self_device_time_total / 1e3

    for full in (True, False):
        img = make_synthetic_image(num_phones=PHONES, num_states=CLASSES,
                                   full_context=full)
        tag = "untied" if full else "non-cube"
        for beam in (None, BEAM):
            dec = ViterbiDecoder(img, pip=20.0, lmw=1.0, beam=beam,
                                 backend="xla", device="cuda")
            tables = dec._scan
            pack = dec._time_pack_for(T)

            def run(route):
                return vscan.viterbi_scan_forward(tables, lp, pack,
                                                  route=route)

            a, b = run(None), run("global")
            if not (torch.equal(a[0], b[0]) and torch.equal(
                    a[1].nan_to_num(0.0), b[1].nan_to_num(0.0))):
                sys.exit(f"{tag} beam {beam}: the two routes differ")
            del a, b
            ms = {None: [], "global": []}
            for route in (None, "global", "global", None):
                ms[route].append(events_ms(lambda: run(route)))
            dev = {r: device_ms(lambda: run(r), KERNELS[r]) for r in ms}
            plan = tables.plan

            def shown(x):
                return "not measured" if x is None else f"{x:.3f} ms"

            print(f"[bench_viterbi_scan] {tag} F={tables.width} "
                  f"{'beam ' + str(beam) if beam else 'exact'}: cluster "
                  f"route (c={plan.cluster}, "
                  f"{vscan.scan_cluster_capacity(tables)} co-resident) "
                  f"{sum(ms[None]) / 2:.3f} ms ({ms[None][0]:.3f}, "
                  f"{ms[None][1]:.3f}), device {shown(dev[None])}; "
                  f"device-memory route {sum(ms['global']) / 2:.3f} ms "
                  f"({ms['global'][0]:.3f}, {ms['global'][1]:.3f}), device "
                  f"{shown(dev['global'])}; bit-equal [{card}]", flush=True)


if __name__ == "__main__":
    main()
