#!/usr/bin/env python3
"""The ``fbank`` kernel's times on one NVIDIA card, at chip_smoke.py's
phase-24 and phase-25 shapes, for this tree or another checkout's.

    python3 bench_fbank.py [ROOT]

On one seeded waveform of 50,221 frames (the synthetic test set's audio,
502.2 s at 16 kHz): the device time (profiler, summed over 20 calls
after a warm-up call) of ``fbank_cuda`` (the waveform entry, framing
included) and of ``fbank_frames`` on ``frame_signal``'s frames, each
also by CUDA events around 20 calls (host time between launches
included), and cuFFT's ``torch.fft.rfft(frames * win, n=512)`` as a
yardstick of like work. Then phase 25's features stage: one
``fbank_cuda`` call per waveform of the 128 test utterances' frame
counts, the device time of its ``fbank`` kernels summed under the
profiler (chip_smoke.py's phase-25 measurement), and its host wall time
with CMN and the copy to the host. Without ROOT, also the waveform
entry (device time and CUDA events) of the measurement builds of
``csrc/fbank.cu`` (``-DFBANK_LEAVE_OUT``, values wrong, times only; into
``build/fbank_variants/``, ignored by git): 1 leaves out the mel sums,
3 also the second pass and the split step, 4 everything but staging the
samples and storing. The profiler now and then drops device events,
which lowers a device time; CUDA events include host time between
launches. With ROOT (e.g. a
parent's tree unpacked under ``lab/``) that tree's package is timed;
compare two trees only within one command, in turns. Prints one line
per number, the card's name and power limit, and last one JSON object.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else Path(
    __file__).resolve().parent
HERE = Path(__file__).resolve().parent
REPS = 20
LEAVE_OUT = {"no mel sums": 1, "no pass 2, split or mel sums": 3,
             "staging and stores only": 4}


def build_variants(kernels):
    """One library per LEAVE_OUT value, all nvcc processes together."""
    out = HERE / "build" / "fbank_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, knob in LEAVE_OUT.items():
        so = out / f"fbank_leave_out_{knob}.so"
        procs[name] = (so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS,
             f"-DFBANK_LEAVE_OUT={knob}", "-o", str(so),
             str(kernels.CSRC / kernels.SOURCES["fbank"])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"{so.name} did not build:\n{log}")
        libs[name] = so
    return libs


def main():
    import ctypes

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("bench_fbank.py: needs a CUDA card")
    # this tree's chip_smoke.py (it imports no package at the top), then
    # ROOT's package
    sys.path.insert(0, str(HERE))
    from chip_smoke import cuda_ms, device_ms, fbank_batch_device_ms
    sys.path.insert(0, str(ROOT))
    from nnacousticmodeling_tpu_torch import kernels
    from nnacousticmodeling_tpu_torch.decoder.image import (
        make_synthetic_image)
    from nnacousticmodeling_tpu_torch.ops import features
    from nnacousticmodeling_tpu_torch.utils.synthetic import (
        make_synthetic_corpus)
    assert Path(features.__file__).resolve().is_relative_to(ROOT)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    kernels.build(["fbank"])
    variants = build_variants(kernels) if ROOT == HERE else {}

    img = make_synthetic_image(num_phones=48, num_states=1909,
                               pdf_tied_transitions=True)
    corpus = make_synthetic_corpus(img, dim=40, num_train=128, num_dev=1,
                                   num_test=128, seed=0, min_phones=40,
                                   max_phones=48)
    lengths = np.diff(corpus.test.offsets)
    n_frames = int(lengths.sum())
    rng = np.random.default_rng(24)
    wave = torch.from_numpy((rng.standard_normal(
        400 + (n_frames - 1) * 160) * 0.1).astype(np.float32)).to(dev)
    fr = features.frame_signal(wave)
    win = torch.from_numpy(features.povey_window()).to(dev)
    res = {"root": str(ROOT), "frames": n_frames, "card": card}
    calls = {"waveform": lambda: features.fbank_cuda(wave),
             "frames": lambda: features.fbank_frames(fr),
             "cufft": lambda: torch.fft.rfft(fr * win, n=512)}
    for name, fn in calls.items():
        res[f"{name}_device_ms"] = device_ms(torch, fn, REPS)
        res[f"{name}_events_ms"] = cuda_ms(torch, fn, REPS)

    waves = [(rng.standard_normal(400 + (int(t) - 1) * 160) * 0.1
              ).astype(np.float32) for t in lengths]

    def stage():
        fbs = [features.fbank_cuda(w) for w in waves]
        return torch.cat([features.cmn(f) for f in fbs]).cpu().numpy()

    stage()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        stage()
        walls.append((time.perf_counter() - t0) * 1e3)
    res["features_stage_wall_ms"] = walls
    res["batch_fbank_device_ms"], res["batch_fbank_kernels_recorded"] = (
        fbank_batch_device_ms(torch, features, waves))

    packaged = kernels._libs["fbank"]
    for name, so in variants.items():
        kernels._libs["fbank"] = ctypes.CDLL(str(so))
        fn = calls["waveform"]
        res[f"waveform_ms, {name}"] = (device_ms(torch, fn, REPS),
                                       cuda_ms(torch, fn, REPS))
    kernels._libs["fbank"] = packaged
    for k, v in res.items():
        print(f"[bench_fbank] {k}: {v}", flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
