#!/usr/bin/env python3
"""The ``viterbi_backtrace`` kernel's time a walk and a hop on one NVIDIA
card, at chip_smoke.py's decode shape (128 utterances, T=512), on the
synthetic 48-phone 1909-pdf image's tables, beside the latency of one
dependent global load.

    python3 bench_backtrace.py [ROOT]

Walks are planted in a packed buffer: every utterance walks from frame
511 to frame 0 in exactly n hops (n = 2 to 200, frames evenly spaced,
seeded random predecessors), in the collapsed decoder's mode (bi2lane,
2304 biphones) and in the scan twin's lane-map mode (110,592 triphones
-> 2304 lanes). Each walk is first held bit-equal to the plain walk.
Then, for each n, the kernel on each route of the mode (the collapsed
tables staged in shared memory; the lane map's int16 copy staged,
``shared``, or its table read through the read-only path, ``global``),
and with ROOT (a tree whose kernel has the C interface of ``b730bb7``,
e.g. a parent's unpacked under ``lab/``) that tree's kernel, in turns
(parent, shared, global, global, shared, parent): the
ms with L2 flushed before each launch (CUDA events after a 256 MB
write, 20 launches, all queued while the card sleeps) and warm (device
time under the profiler, 20 launches). us a hop is the slope between
n = 2 and n = 200.

The chase (``backtrace_chase``, an entry of ``csrc/viterbi_backtrace.cu``
used only here): one thread follows 4096 links planted in distinct 128-B
lines of a buffer the size of the lane-map mode's packed rows (604 MB),
64 and 1024 hops, flushed (HBM) and warm (the second run of the same
links: L2); the latency of a dependent load is the slope.

Last, rows built as chip_smoke.py builds them: phase 4's random
posteriors (walks of a few segments; phases 22 and 23 walk them) and
phase 5's target rows (walks of a trained model's length), each through
the collapsed forward (phase 5's), the cube kernel (phase 22's) and the
untied image's scan twin (phase 23's); each route and the parent in
turns as above, each first held bit-equal to the plain walk. Prints one line per
number, the card's name and power limit, and last one JSON object.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else None
HERE = Path(__file__).resolve().parent
U, T, PHONES, CLASSES, REPS = 128, 512, 48, 1909, 20
WALKS = (2, 10, 25, 50, 100, 200)
FLUSH_BYTES = 256 * 2 ** 20


def build_parent(kernels, root):
    """ROOT's backtrace source, built into build/backtrace_parent/."""
    out = HERE / "build" / "backtrace_parent"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libviterbi_backtrace_parent.so"
    src = root / "nnacousticmodeling_tpu_torch" / "csrc" / "viterbi_backtrace.cu"
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(so),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"{src} did not build:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.viterbi_backtrace.argtypes = ([ctypes.c_void_p] * 7
                                      + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.viterbi_backtrace.restype = ctypes.c_int
    return lib


def plant(np, torch, tables, packed, end, n, pack, rng):
    """Plant walks of exactly n hops from frame T-1 of every utterance
    into ``packed`` (U, T, L) and ``end`` (U, T, E) on the card."""
    P = tables.num_phones
    step = tables.step_map.cpu().numpy()
    end_map = tables.end_map.cpu().numpy()
    lanes_mode = tables.mode == 0
    frames = [((n - i) * T) // n - 1 for i in range(n + 1)]
    rows = np.arange(U)
    first = rng.integers(0, end_map.size, U)
    end[:, T - 1] = 0.0
    end[torch.from_numpy(rows), T - 1, torch.from_numpy(first)] = 1.0
    cur = end_map[first]
    b, c = np.divmod(cur, P)
    us, ts, ls, vals = [], [], [], []
    for i in range(n):
        lane = cur if lanes_mode else step[b * P + c]
        q = rng.integers(0, step.size if lanes_mode else P, U)
        us.append(rows)
        ts.append(np.full(U, frames[i]))
        ls.append(lane)
        vals.append(q * pack + frames[i + 1] + 1)
        if lanes_mode:
            cur = step[q]
        else:
            b, c = q, b
    idx = [torch.from_numpy(np.concatenate(a)).to(packed.device)
           for a in (us, ts, ls)]
    packed[idx[0], idx[1], idx[2]] = torch.from_numpy(
        np.concatenate(vals).astype(np.int32)).to(packed.device)


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("bench_backtrace.py: needs a CUDA card")
    sys.path.insert(0, str(HERE))
    from chip_smoke import (CORPUS, SLEEP_CYCLES, device_profile,
                            random_lp, target_lp)
    from nnacousticmodeling_tpu_torch import kernels
    from nnacousticmodeling_tpu_torch.decoder import viterbi_backtrace as vbt
    from nnacousticmodeling_tpu_torch.decoder.image import (
        make_synthetic_image)
    from nnacousticmodeling_tpu_torch.decoder.viterbi import ViterbiDecoder
    from nnacousticmodeling_tpu_torch.utils.synthetic import (
        make_synthetic_corpus)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    kernels.build(["viterbi_backtrace"])
    parent = build_parent(kernels, ROOT) if ROOT is not None else None
    img = make_synthetic_image(num_phones=PHONES, num_states=CLASSES,
                               pdf_tied_transitions=True)
    dec = ViterbiDecoder(img, pip=20.0, lmw=1.0, backend="collapsed",
                         device=dev)
    modes = {"collapsed": (dec._bt_collapsed, dec._collapsed_fwd.L,
                           dec._collapsed_fwd.pack),
             "lanes": (dec._bt_scan, img.num_biphones, dec._time_pack_for(T))}
    lens = torch.full((U,), T, dtype=torch.int32, device=dev)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    res = {}

    def put(key, value):
        res[key] = value
        print(f"[bench_backtrace] {key}: {value}", flush=True)

    for key, value in (("card", card), ("root", str(ROOT) if ROOT else None),
                       ("U", U), ("T", T)):
        put(key, value)
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream

    def flushed_ms(fn):
        fn()
        torch.cuda._sleep(SLEEP_CYCLES)   # the host queues every launch
        pairs = []
        for _ in range(REPS):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            pairs.append((start, stop))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / REPS

    def warm_ms(fn):
        """Device ms a call: REPS calls under the profiler after one
        warm-up (a session the profiler drops is taken again)."""
        fn()
        torch.cuda.synchronize()
        for _ in range(10):
            busy = device_profile(torch, lambda: [fn() for _ in range(REPS)])[1]
            if busy > 0:
                return busy / REPS
        sys.exit("the profiler recorded no device time in 10 sessions")

    def timed(tag, args):
        """Every route and the parent on ``args`` against the plain walk,
        then timed in turns under ``tag``. Returns the plain walk."""
        tables, packed, end, lens_, pack = args
        want = vbt.viterbi_backtrace_reference(*args)
        segs = torch.empty_like(want[0])
        counts = torch.empty_like(want[1])

        def run_parent():
            kernels.check(parent.viterbi_backtrace(
                packed.data_ptr(), end.data_ptr(), lens_.data_ptr(),
                tables.end_map32.data_ptr(), tables.step_map32.data_ptr(),
                segs.data_ptr(), counts.data_ptr(), *packed.shape,
                tables.end_map32.numel(), tables.step_map32.numel(),
                tables.num_phones, pack, tables.mode, stream), "parent")

        calls = {r: (lambda r=r: vbt.viterbi_backtrace(*args, route=r))
                 for r in vbt.backtrace_routes(tables)}
        outs = {r: call() for r, call in calls.items()}
        if parent is not None:
            calls["parent"] = run_parent
            run_parent()
            outs["parent"] = (segs.clone(), counts.clone())
        for k, got in outs.items():
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                sys.exit(f"{tag}: the {k} kernel differs from the plain "
                         f"walk")
        order = [k for k in ("parent", "shared", "global", "global",
                             "shared", "parent") if k in calls]
        times = {k: ([], []) for k in calls}
        for k in order:
            times[k][0].append(flushed_ms(calls[k]))
            times[k][1].append(warm_ms(calls[k]))
        for k, (fl, wm) in times.items():
            put(f"{tag} {k} ms flushed", fl)
            put(f"{tag} {k} ms warm", wm)
        return want

    for mode, (tables, L, pack) in modes.items():
        packed = torch.zeros((U, T, L), dtype=torch.int32, device=dev)
        end = torch.zeros((U, T, tables.end_map.numel()), device=dev)
        for n in WALKS:
            plant(np, torch, tables, packed, end, n, pack, rng)
            want = timed(f"{mode} n={n}", (tables, packed, end, lens, pack))
            if not bool((want[1] == n).all()):
                sys.exit(f"{mode} n={n}: planted walks of {want[1].tolist()}")
        for k in ("shared", "global", "parent"):
            for kind in ("flushed", "warm"):
                got = [res.get(f"{mode} n={n} {k} ms {kind}")
                       for n in (WALKS[0], WALKS[-1])]
                if got[0] is not None:
                    put(f"{mode} {k} us a hop {kind}", float(
                        (np.mean(got[1]) - np.mean(got[0])) * 1e3
                        / (WALKS[-1] - WALKS[0])))
        del packed, end

    # the chase: one dependent load a hop over packed's size
    lib = kernels.load("viterbi_backtrace")
    lib.backtrace_chase.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_void_p]
    lib.backtrace_chase.restype = ctypes.c_int
    size = U * T * img.num_biphones
    links = rng.choice(size // 32, 4097, replace=False) * 32
    buf = torch.zeros(size, dtype=torch.int32, device=dev)
    buf[torch.from_numpy(links[:-1]).to(dev)] = torch.from_numpy(
        links[1:].astype(np.int32)).to(dev)
    out = torch.zeros(1, dtype=torch.int32, device=dev)

    def chase(hops):
        kernels.check(lib.backtrace_chase(buf.data_ptr(), int(links[0]), hops,
                                          out.data_ptr(), stream), "chase")

    for hops in (64, 1024):
        put(f"chase {hops} hops ms flushed", flushed_ms(lambda: chase(hops)))
        warm = []
        for _ in range(REPS):
            chase(hops)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            chase(hops)
            stop.record()
            torch.cuda.synchronize()
            warm.append(start.elapsed_time(stop))
        put(f"chase {hops} hops ms warm", sum(warm) / REPS)
        if int(out) != int(links[hops]):
            sys.exit(f"the chase ended at {int(out)}, not {links[hops]}")
    for kind in ("flushed", "warm"):
        put(f"chase us a load {kind}", (
            (res[f"chase 1024 hops ms {kind}"] - res[f"chase 64 hops ms {kind}"])
            * 1e3 / (1024 - 64)))
    del buf

    # chip_smoke.py's rows: phases 5, 22 and 23, random and target
    corpus = make_synthetic_corpus(img, **CORPUS)
    lp_rand, lens_rand = random_lp(torch, np, dev)
    lp_tgt = target_lp(torch, np, dev, corpus)
    lens_tgt = torch.from_numpy(np.diff(corpus.test.offsets).astype(
        np.int32)).to(dev)
    cube = ViterbiDecoder(img, pip=20.0, lmw=1.0, backend="pallas",
                          device=dev)
    untied = ViterbiDecoder(make_synthetic_image(
        num_phones=PHONES, num_states=CLASSES), pip=20.0, lmw=1.0, device=dev)
    pack_t = cube._time_pack_for(T)
    for rows, lp, lens_ in (("random", lp_rand, lens_rand),
                            ("target", lp_tgt, lens_tgt)):
        for tag, tables, fwd, pack in (
                ("collapsed", dec._bt_collapsed, dec._collapsed_fwd.forward,
                 dec._collapsed_fwd.pack),
                ("cube", cube._bt_cube, cube._pallas_fwd.forward, pack_t),
                ("scan twin", untied._bt_scan,
                 lambda lp, lens: untied._forward_scan(lp), pack_t)):
            packed, end = fwd(lp, lens_)
            want = timed(f"{tag} {rows} rows",
                         (tables, packed, end, lens_, pack))
            put(f"{tag} {rows} rows longest walk", int(want[1].max()))
            put(f"{tag} {rows} rows hops", int(want[1].sum()))
            del packed, end
    print(card, flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
