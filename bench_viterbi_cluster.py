#!/usr/bin/env python3
"""The two Viterbi kernels' routes, and what a cluster-route frame spends,
on one NVIDIA card, at chip_smoke.py's phase-4 shape: 128 utterances of
320-479 frames (T=512) of seeded Dirichlet posteriors on the synthetic
48-phone 1909-pdf image.

    python3 bench_viterbi_cluster.py [ROOT]

For the collapsed and the dense-cube kernel, exact and with the beam:
the cluster route (``csrc/viterbi_cluster.cuh``, the image's plan) and
the device-memory route, each held bit-equal to its plain version
within lengths, timed in turns (cluster, device memory, device memory,
cluster; CUDA events, 3 calls after a warm-up call), with the peak
device memory a call allocates. Per frame: the cluster route's time
over the frames each of the card's co-resident clusters walks (ms x
clusters / frames), the device-memory route's over the longest
utterance (all 128 blocks run at once). Then, exact only, the
measurement builds of ``VIT_LEAVE_OUT`` (values wrong, times only): 1
reads every row step's cell records from row step 0 (L1 hits, no L2
stream), 2 leaves out the cluster barrier and the exchange of the
exported row, 3 both; they go to ``build/viterbi_variants/`` (ignored
by git). With ROOT (another checkout's tree, e.g. a parent's unpacked
under ``lab/``), times that tree's two routes instead, without the
variants. Prints one line per row and the card's name and power limit.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else Path(
    __file__).resolve().parent
HERE = Path(__file__).resolve().parent
U, T, PHONES, CLASSES, BEAM, REPS = 128, 512, 48, 1909, 8.0, 3
LEAVE_OUT = {"no L2 records": 1, "no exchange": 2, "neither": 3}


def build(kernels, out):
    """One library per kernel and knob, all nvcc processes together."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in ("viterbi_collapsed", "viterbi_cube"):
        for knob in LEAVE_OUT.values():
            so = out / f"{src}_{knob}.so"
            procs[so] = subprocess.Popen(
                [kernels._nvcc(), *kernels.NVCC_FLAGS,
                 f"-DVIT_LEAVE_OUT={knob}", "-o", str(so),
                 str(kernels.CSRC / kernels.SOURCES[src])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for so, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"{so.name} did not build:\n{log}")


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
        build(kernels, out)

    img = make_synthetic_image(num_phones=PHONES, num_states=CLASSES,
                               pdf_tied_transitions=True)
    rng = np.random.default_rng(1)
    lens_np = rng.integers(int(0.8 * 400), int(1.2 * 400), U).astype(np.int32)
    lp = torch.from_numpy(np.log(rng.dirichlet(
        np.ones(CLASSES), size=(U, T))).astype(np.float32)).to(dev)
    lens = torch.from_numpy(lens_np).to(dev)
    frames, longest = int(lens_np.sum()), int(lens_np.max())
    mask = (torch.arange(T, device=dev)[None, :] < lens[:, None].long())

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
            plan = obj.plan
            clusters = capacity(obj)
            want = ref(obj, lp, lens)
            res = {}
            for route in (None, "global", "global", None):
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
                        sys.exit(f"{kind} route {route}: {bad} values differ "
                                 f"from plain, repeat bit-identical {same}")
                    del got, again
                    res[route] = dict(ms=[], peak=peak_bytes(call))
                res[route]["ms"].append(ms(call))
            for route, r in res.items():
                t = sum(r["ms"]) / len(r["ms"])
                per = (t * 1e3 * clusters / frames if route is None
                       else t * 1e3 / longest)
                name = ("cluster c=%d, %d co-resident" % (plan.cluster,
                                                          clusters)
                        if route is None else "device memory")
                print(f"{kind} {'beam' if beam else 'exact'} {name}: "
                      f"{t:.3f} ms ({', '.join(f'{x:.3f}' for x in r['ms'])}"
                      f"), {per:.2f} us a frame, peak "
                      f"{r['peak'] / 1e6:.1f} MB; bit-equal to plain, a "
                      f"second call bit-identical [{card}]", flush=True)
        if not variants:
            continue
        dec = ViterbiDecoder(img, pip=20.0, lmw=1.0, backend=backend,
                             device=dev)
        obj = dec._collapsed_fwd if kind == "collapsed" else dec._pallas_fwd
        stream = torch.cuda.current_stream(dev).cuda_stream
        packaged = lib_of()
        for tag, knob in LEAVE_OUT.items():
            lib = ctypes.CDLL(str(out / f"{src}_{knob}.so"))
            name = f"{kind}_viterbi_cluster"
            getattr(lib, name).argtypes = getattr(packaged, name).argtypes
            getattr(lib, name).restype = ctypes.c_int
            t = ms(lambda: launch(obj, lp, lens, obj.plan, lib, stream))
            print(f"{kind} exact VIT_LEAVE_OUT={knob} ({tag}): {t:.3f} ms, "
                  f"{t * 1e3 * clusters / frames:.2f} us a frame [{card}]",
                  flush=True)


if __name__ == "__main__":
    main()
