#!/usr/bin/env python3
"""What a step of the persistent PeepholeLSTM training kernels spends, on
one NVIDIA card: builds ``csrc/peephole_train.cu`` with the measurement
knobs of ``csrc/peephole_persistent.cuh`` set, one library per variant,
and times each kernel's step (the profiler's device time, the slope
between T=5 and T=20) at B=128, H=1024.

    python3 bench_peephole_ring_variants.py

Variants: ``base`` (the kernels as the package builds them: 128-wide
ring stages, 3 deep, beside the resident weight slice); ``kc64s6``
(64-wide stages, 6 deep); ``kc128s2`` (128-wide, 2 deep: no load in
flight while a stage is computed); then variants that compute wrong
values and serve only to split a step's time: ``zerofill`` (each stage
writes zeros into shared memory instead of loading the exchange rows
from L2), ``noload`` (the stages are neither loaded nor written),
``nomma`` (loaded, the tensor-core products left out) and ``noring``
(neither: the barriers, the elementwise work and the stores alone). The
libraries go to ``build/ring_variants/`` (ignored by git). Prints one
line per variant and the card's name and power limit.
"""

import ctypes
import functools
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H, B, TS, REPS, SESSIONS = 1024, 128, (5, 20), 10, 3
VARIANTS = {
    "base": [],
    "kc64s6": ["-DPEEP_RING_KC=64", "-DPEEP_RING_STAGES=6"],
    "kc128s2": ["-DPEEP_RING_STAGES=2"],
    "zerofill": ["-DPEEP_LEAVE_OUT=4"],
    "noload": ["-DPEEP_LEAVE_OUT=1"],
    "nomma": ["-DPEEP_LEAVE_OUT=2"],
    "noring": ["-DPEEP_LEAVE_OUT=3"],
}


def build(kernels, out):
    """One library per variant, all nvcc processes started together."""
    out.mkdir(parents=True, exist_ok=True)
    src = ROOT / "nnacousticmodeling_tpu_torch" / "csrc" / "peephole_train.cu"
    procs = {name: subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, *flags, "-o",
         str(out / f"{name}.so"), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, flags in VARIANTS.items()}
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
        sys.exit("bench_peephole_ring_variants.py: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from nnacousticmodeling_tpu_torch import kernels
    from nnacousticmodeling_tpu_torch.ops import rnn_cuda as r
    out = ROOT / "build" / "ring_variants"
    build(kernels, out)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator().manual_seed(0)
    wh = (torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(dev)
    peeps = [(torch.randn(H, H, generator=g) / H ** 0.5).to(dev)
             for _ in range(3)]
    inputs = {}
    for t in TS:
        inputs[t] = [torch.randn(t, B, 4 * H, generator=g).to(dev),
                     (torch.randn(B, H, generator=g) * 0.1).to(dev),
                     (torch.randn(B, H, generator=g) * 0.1).to(dev),
                     torch.randn(t, B, H, generator=g).to(dev)]
    for name in VARIANTS:
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for fn in (lib.peephole_train_fwd_f32, lib.peephole_train_bwd_f32):
            fn.argtypes = r._PEEP_TRAIN_ARGTYPES
            fn.restype = ctypes.c_int
        lib.peephole_train_capacity.argtypes = [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.peephole_train_capacity.restype = ctypes.c_int
        r._CAPACITY.clear()
        ms = {}
        for t, (proj, c0, h0, dhs) in inputs.items():
            def fwd():
                return r._peep_train_forward_launch(
                    lib.peephole_train_fwd_f32,
                    functools.partial(lib.peephole_train_capacity, 0), proj,
                    wh, *peeps, c0, h0, stream)
            res = fwd()[1]

            def bwd():
                return r._peep_train_backward_launch(
                    lib.peephole_train_bwd_f32,
                    functools.partial(lib.peephole_train_capacity, 1), res,
                    wh, *peeps, dhs, c0, h0, torch.float32, stream)
            ms[t] = (kernel_ms(torch, fwd, "peephole_train_fwd_persistent"),
                     kernel_ms(torch, bwd, "peephole_train_bwd_persistent"))
        steps = [(ms[TS[1]][i] - ms[TS[0]][i]) * 1e3 / (TS[1] - TS[0])
                 for i in (0, 1)]
        print(f"{name}: forward T={TS[1]} {ms[TS[1]][0]:.4f} ms, "
              f"{steps[0]:.2f} us a step; backward T={TS[1]} "
              f"{ms[TS[1]][1]:.4f} ms, {steps[1]:.2f} us a reverse step "
              f"(B={B}, H={H}) [{card}]", flush=True)
    r._CAPACITY.clear()


if __name__ == "__main__":
    main()
