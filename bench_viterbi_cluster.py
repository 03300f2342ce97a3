#!/usr/bin/env python3
"""The two Viterbi kernels' routes, and what a cluster-route frame spends,
on one NVIDIA card, at chip_smoke.py's phase-4 shape: 128 utterances of
320-479 frames (T=512) of seeded Dirichlet posteriors on the synthetic
48-phone 1909-pdf image.

    python3 bench_viterbi_cluster.py [ROOT]

For the collapsed and the dense-cube kernel, exact and with the beam:
the cluster route (``csrc/viterbi_cluster.cuh``) with the DP state in
registers (the collapsed kernel's plan) and in shared memory
(``route="shared"``; the cube kernel's plan), and the device-memory
route, each held bit-equal to its plain version within lengths, timed
in turns (registers, shared memory, device memory, device memory,
shared memory, registers; CUDA events, 3 calls after a warm-up call),
with the peak device memory a call allocates.
Per frame: a cluster route's time over the frames each of the card's
co-resident clusters walks (ms x clusters / frames), the device-memory
route's over the longest utterance (all 128 blocks run at once). Then
the collapsed kernel's register route at fewer row steps against the
shared-memory route on the same cluster, exact, on images whose pdfs
give a slice of one chunk a warp: 8 phones (8 rows, 2 row steps), 32
phones with 3,500 pdfs (8 steps) and 40 phones with 2,500 pdfs (10
steps), at the same batch. Then,
exact only, each cluster route in the measurement builds of
``VIT_LEAVE_OUT`` (values wrong, times only): 1 reads every row step's
cell records from row step 0 (L1 hits, no L2 stream), 2 leaves out the
cluster barrier and the exchange of the exported row, 3 both; they go
to ``build/viterbi_variants/`` (ignored by git), and ``ptxas`` reports
each cluster kernel's registers and spill bytes in the package's build
(``VIT_LEAVE_OUT=0``). With ROOT (another checkout's tree, e.g. a
parent's unpacked under ``lab/``), times that tree's routes instead,
without the variants. Prints one line per row and the card's name and
power limit.
"""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else Path(
    __file__).resolve().parent
HERE = Path(__file__).resolve().parent
U, T, PHONES, CLASSES, BEAM, REPS = 128, 512, 48, 1909, 8.0, 3
FEWER_STEPS = ((8, CLASSES), (32, 3500), (40, 2500))     # (phones, pdfs)
LEAVE_OUT = {"no L2 records": 1, "no exchange": 2, "neither": 3}


def build(kernels, out):
    """One library per kernel and knob (0: the package's code), all nvcc
    processes together; returns each knob-0 build's ptxas report."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in ("viterbi_collapsed", "viterbi_cube"):
        for knob in (0, *LEAVE_OUT.values()):
            so = out / f"{src}_{knob}.so"
            procs[src, knob] = so, subprocess.Popen(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
                 f"-DVIT_LEAVE_OUT={knob}", "-o", str(so),
                 str(kernels.CSRC / kernels.SOURCES[src])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    reports = {}
    for (src, knob), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"{so.name} did not build:\n{log}")
        if knob == 0:
            reports[src] = log
    return reports


def ptxas_lines(report):
    """(kernel, registers, spill stores, spill loads, stack bytes) of each
    cluster-route instantiation in a ptxas -v report."""
    rows, name, spill = [], None, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(collapsed|cube)_viterbi_cluster_kernel"
                          r"(?:ILi(\d+)E)?", m.group(1))
            name = (f"{k.group(1)}_viterbi_cluster_kernel"
                    + (f"<{k.group(2)}>" if k.group(2) else "") if k else None)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            spill = tuple(int(x) for x in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), spill[1], spill[2],
                         spill[0]))
            name = None
    return rows


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("bench_viterbi_cluster.py: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from nnacousticmodeling_tpu_torch import kernels
    from nnacousticmodeling_tpu_torch.decoder import viterbi_collapsed as vc
    from nnacousticmodeling_tpu_torch.decoder import viterbi_cube as vcube
    from nnacousticmodeling_tpu_torch.decoder.image import (
        make_synthetic_image)
    from nnacousticmodeling_tpu_torch.decoder.viterbi import ViterbiDecoder
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    kernels.build(["viterbi_collapsed", "viterbi_cube"])
    variants = ROOT == HERE
    if variants:
        out = HERE / "build" / "viterbi_variants"
        for src, report in build(kernels, out).items():
            for row in ptxas_lines(report):
                print("ptxas %s: %d registers, %d bytes spill stores, %d "
                      "bytes spill loads, %d bytes stack frame" % row,
                      flush=True)
    # a tree before the register route has one cluster route, the plan's
    shared_route = hasattr(vc, "REG_STEPS")

    img = make_synthetic_image(num_phones=PHONES, num_states=CLASSES,
                               pdf_tied_transitions=True)

    def inputs(classes):
        """Seeded Dirichlet posteriors of ``classes`` pdfs, lengths."""
        rng = np.random.default_rng(1)
        lens_np = rng.integers(int(0.8 * 400), int(1.2 * 400),
                               U).astype(np.int32)
        lp = torch.from_numpy(np.log(rng.dirichlet(
            np.ones(classes), size=(U, T))).astype(np.float32)).to(dev)
        return lp, torch.from_numpy(lens_np).to(dev)

    lp, lens = inputs(CLASSES)
    frames, longest = int(lens.sum()), int(lens.max())

    def ms(fn):
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

    def peak_bytes(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    def plans_of(obj):
        """The plan's route and, where it keeps the state in registers, the
        same cluster with the state in shared memory."""
        plans = {None: obj.plan}
        if shared_route and obj.plan.registers:
            plans["shared"] = vc._route("bench", obj.plan, "shared",
                                        (obj.PS, obj.tps.shape[2], obj.S))
        return plans

    def time_routes(label, obj, fwd, ref, capacity, routes, lp, lens):
        """``routes`` of ``fwd`` timed in turns (forwards, then backwards),
        each first held bit-equal to plain; one line a route."""
        mask = (torch.arange(T, device=dev)[None, :] < lens[:, None].long())
        frames, longest = int(lens.sum()), int(lens.max())
        plans = plans_of(obj)
        want = ref(obj, lp, lens)
        res = {}
        for route in (*routes, *reversed(routes)):
            call = lambda: fwd(obj, lp, lens, route=route)  # noqa: E731
            if route not in res:
                got = call()
                again = call()
                torch.cuda.synchronize()
                bad = sum(int((g != w)[mask].sum())
                          for g, w in zip(got, want))
                same = all(torch.equal(g[mask], a[mask])
                           for g, a in zip(got, again))
                if bad or not same:
                    sys.exit(f"{label} route {route}: {bad} values differ "
                             f"from plain, repeat bit-identical {same}")
                del got, again
                res[route] = dict(ms=[], peak=peak_bytes(call))
            res[route]["ms"].append(ms(call))
        for route, r in res.items():
            t = sum(r["ms"]) / len(r["ms"])
            if route in plans:
                plan = plans[route]
                clusters = (capacity(obj) if plan == obj.plan
                            else capacity(obj, plan))
                per = t * 1e3 * clusters / frames
                home = ("registers" if getattr(plan, "registers", False)
                        else "shared memory")
                name = (f"cluster c={plan.cluster}, state in {home}, "
                        f"{clusters} co-resident")
            else:
                per, name = t * 1e3 / longest, "device memory"
            print(f"{label} {name}: {t:.3f} ms "
                  f"({', '.join(f'{x:.3f}' for x in r['ms'])}), {per:.2f} "
                  f"us a frame, peak {r['peak'] / 1e6:.1f} MB; bit-equal to "
                  f"plain, a second call bit-identical [{card}]", flush=True)

    print(f"[bench_viterbi_cluster] {ROOT.name}: U={U} T={T} frames={frames}"
          f" longest={longest} [{card}]", flush=True)
    kinds = (("collapsed", "auto", vc.collapsed_viterbi_forward,
              vc.collapsed_viterbi_reference, vc.collapsed_cluster_capacity,
              "viterbi_collapsed", vc._collapsed_launch, vc._lib),
             ("cube", "pallas", vcube.cube_viterbi_forward,
              vcube.cube_viterbi_reference, vcube.cube_cluster_capacity,
              "viterbi_cube", vcube._cube_launch, vcube._lib))
    for kind, backend, fwd, ref, capacity, src, launch, lib_of in kinds:
        for beam in (None, BEAM):
            dec = ViterbiDecoder(img, pip=20.0, lmw=1.0, beam=beam,
                                 backend=backend, device=dev)
            obj = dec._collapsed_fwd if kind == "collapsed" else \
                dec._pallas_fwd
            plans = plans_of(obj)
            time_routes(f"{kind} {'beam' if beam else 'exact'}", obj, fwd,
                        ref, capacity, (*plans, "global"), lp, lens)
        if not variants:
            continue
        dec = ViterbiDecoder(img, pip=20.0, lmw=1.0, backend=backend,
                             device=dev)
        obj = dec._collapsed_fwd if kind == "collapsed" else dec._pallas_fwd
        stream = torch.cuda.current_stream(dev).cuda_stream
        packaged = lib_of()
        libs = {}
        for knob in (0, *LEAVE_OUT.values()):
            lib = libs[knob] = ctypes.CDLL(str(out / f"{src}_{knob}.so"))
            name = f"{kind}_viterbi_cluster"
            getattr(lib, name).argtypes = getattr(packaged, name).argtypes
            getattr(lib, name).restype = ctypes.c_int
        for route, plan in plans.items():
            clusters = (capacity(obj) if plan == obj.plan
                        else capacity(obj, plan))
            home = "registers" if plan.registers else "shared memory"
            for tag, knob in {"package": 0, **LEAVE_OUT}.items():
                t = ms(lambda: launch(obj, lp, lens, plan, libs[knob],
                                      stream))
                print(f"{kind} exact, state in {home}, VIT_LEAVE_OUT={knob} "
                      f"({tag}): {t:.3f} ms, "
                      f"{t * 1e3 * clusters / frames:.2f} us a frame "
                      f"[{card}]", flush=True)
    if not shared_route:
        return
    for phones, classes in FEWER_STEPS:
        few = make_synthetic_image(num_phones=phones, num_states=classes,
                                   pdf_tied_transitions=True)
        obj = ViterbiDecoder(few, pip=20.0, lmw=1.0,
                             device=dev)._collapsed_fwd
        del lp
        lp, lens = inputs(classes)
        time_routes(f"collapsed exact, {phones} phones {classes} pdfs "
                    f"({obj.PS // vc.ROW_GROUPS} row steps)", obj,
                    vc.collapsed_viterbi_forward,
                    vc.collapsed_viterbi_reference,
                    vc.collapsed_cluster_capacity, tuple(plans_of(obj)), lp,
                    lens)


if __name__ == "__main__":
    main()
