#!/usr/bin/env python3
"""The block layouts of the persistent gated training kernels, and what
their steps spend, on one NVIDIA card: builds ``csrc/gated_train.cu`` as
the package does (16 units x 64 rows a block), with ``-DGATED_UNITS=8``
(8 units x 128 rows, the peephole kernels' layout) and with the
measurement knob ``PEEP_LEAVE_OUT`` of the shared ring
(``csrc/peephole_persistent.cuh``), one library each, and times the step
of each library's forward and reverse step of its backward (the
profiler's device time, the slope between T=5 and T=20; the backward
without its dW launch) for gru, mgru_r and mgru at B=128, H=1024.

    python3 bench_gated_layouts.py

The layouts run in turns (16, 8, 8, 16). Each block reads the whole
exchange vector of its rows every phase, so across the grid a phase
reads (H / units) x B x H x 2 bytes from L2: 16 units read half of what
8 do. Then, at 16 units, variants that compute wrong values and serve
only to split a step's time: ``zerofill`` (each ring stage writes zeros
into shared memory instead of loading the exchange rows from L2),
``noload`` (stages neither loaded nor written), ``nomma`` (loaded, the
tensor-core products left out) and ``noring`` (neither: the barriers,
the elementwise work and the stores alone). The backward's phases read
the pair exchange (2H wide) and the dc exchange (H wide): (H / units) x
B x 3H x 2 bytes across the grid a gru step. The libraries go to
``build/gated_layouts/`` (ignored by git). Prints one line per variant,
kind and kernel and the card's name and power limit.
"""

import ctypes
import functools
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
H, B, TS, REPS, SESSIONS = 1024, 128, (5, 20), 10, 3
#: variant -> (nvcc flags, rnn_cuda's GATED_UNITS, GATED_ROWS,
#: GATED_NARROW_ROWS for its layout)
PACKAGED = (16, 64, 32)
VARIANTS = {"16x64": ([], PACKAGED),
            "8x128": (["-DGATED_UNITS=8"], (8, 128, 64)),
            "zerofill": (["-DPEEP_LEAVE_OUT=4"], PACKAGED),
            "noload": (["-DPEEP_LEAVE_OUT=1"], PACKAGED),
            "nomma": (["-DPEEP_LEAVE_OUT=2"], PACKAGED),
            "noring": (["-DPEEP_LEAVE_OUT=3"], PACKAGED)}
ORDER = ("16x64", "8x128", "8x128", "16x64", "zerofill", "noload", "nomma",
         "noring")
KINDS = {"gru": (3, "tanh"), "mgru_r": (3, "relu"), "mgru": (2, "relu")}


def build(kernels, out):
    """One library per variant, all nvcc processes started together."""
    out.mkdir(parents=True, exist_ok=True)
    src = ROOT / "nnacousticmodeling_tpu_torch" / "csrc" / "gated_train.cu"
    procs = {name: subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, *flags, "-o",
         str(out / f"{name}.so"), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, (flags, _) in VARIANTS.items()}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"variant {name} did not build:\n{log}")


def kernel_ms(torch, fn, key):
    """Device milliseconds a call of the kernels whose name holds ``key``:
    the median of SESSIONS profiler sessions of REPS calls each, after one
    warm-up call. A session that recorded no device time is repeated,
    up to twice as many sessions in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(2 * SESSIONS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(ev, "self_device_time_total", 0)
                 for ev in prof.key_averages()
                 if getattr(ev, "device_type", None) == DeviceType.CUDA
                 and key in ev.key)
        if us > 0:
            runs.append(us / 1e3 / REPS)
        if len(runs) == SESSIONS:
            return sorted(runs)[SESSIONS // 2]
    sys.exit(f"the profiler recorded no {key} device time")


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("bench_gated_layouts.py: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from nnacousticmodeling_tpu_torch import kernels
    from nnacousticmodeling_tpu_torch.ops import rnn_cuda as r
    out = ROOT / "build" / "gated_layouts"
    build(kernels, out)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator().manual_seed(0)
    inputs = {}
    for kind, (gp, act) in KINDS.items():
        w1 = (torch.randn(H, 2 * H, generator=g) / H ** 0.5).to(dev)
        w2 = (None if kind == "mgru" else
              (torch.randn(H, H, generator=g) / H ** 0.5).to(dev))
        h0 = (torch.randn(B, H, generator=g) * 0.1).to(dev)
        projs = {t: torch.randn(t, B, gp * H, generator=g).to(dev)
                 for t in TS}
        # the backward's inputs: the packaged forward's residuals, finite
        # in every variant
        grads = {t: (r.gated_train_forward(projs[t], w1, w2, h0, kind=kind,
                                           activation=act)[1],
                     torch.randn(t, B, H, generator=g).to(dev),
                     torch.randn(B, H, generator=g).to(dev)) for t in TS}
        inputs[kind] = (act, w1, w2, h0, projs, grads)
    for name in ORDER:
        units, rows, narrow = VARIANTS[name][1]
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.gated_train_fwd_f32.argtypes = r._GATED_FWD_ARGTYPES
        lib.gated_train_fwd_f32.restype = ctypes.c_int
        lib.gated_train_bwd_f32.argtypes = r._GATED_BWD_ARGTYPES
        lib.gated_train_bwd_f32.restype = ctypes.c_int
        lib.gated_train_capacity.argtypes = [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.gated_train_capacity.restype = ctypes.c_int
        fwd_query = functools.partial(lib.gated_train_capacity, 0)
        bwd_query = functools.partial(lib.gated_train_capacity, 1)
        r._CAPACITY.clear()
        with mock.patch.multiple(r, GATED_UNITS=units, GATED_ROWS=rows,
                                 GATED_NARROW_ROWS=narrow):
            for kind, (act, w1, w2, h0, projs, grads) in inputs.items():
                ms = {"forward": {}, "backward": {}}
                for t, proj in projs.items():
                    def fwd():
                        return r._gated_train_forward_launch(
                            lib.gated_train_fwd_f32, fwd_query, proj, w1, w2,
                            h0, kind, act, stream)
                    ms["forward"][t] = kernel_ms(
                        torch, fwd, "gated_train_fwd_persistent")
                    res, dhs, dht = grads[t]

                    def bwd():
                        return r._gated_train_backward_launch(
                            lib.gated_train_bwd_f32, bwd_query, res, w1, w2,
                            dhs, dht, torch.float32, kind, act, stream)
                    ms["backward"][t] = kernel_ms(
                        torch, bwd, "gated_train_bwd_persistent")
                for which, m in ms.items():
                    step = (m[TS[1]] - m[TS[0]]) * 1e3 / (TS[1] - TS[0])
                    print(f"{name} {kind}: {which} T={TS[1]} "
                          f"{m[TS[1]]:.4f} ms, {step:.2f} us a "
                          f"{'step' if which == 'forward' else 'reverse step'}"
                          f" (B={B}, H={H}) [{card}]", flush=True)
    r._CAPACITY.clear()


if __name__ == "__main__":
    main()
