"""The CTC step's graph memory over several input shapes, and the callers
of its copy kernels, on one card.

    python3 bench_ctc_step.py [ROOT]

ROOT: another checkout whose ``nnacousticmodeling_tpu_torch`` to measure
(e.g. a parent commit unpacked under ``lab/``); default this one. The
model is chip_smoke.py phase 32's (``BiRNNCTC`` over an LSTM 4x1024, 48
phones + blank, seed 3) on a seeded batch of phase 32's shape (B=128,
T=470, 40 features, S=50 labels):

1. ``make_ctc_train_step`` through chip_smoke's CTC_SHAPES: the bytes
   reserved after each shape's capture, over what was reserved before
   the model was made, for the largest shape alone, for CTC_ORDER
   (largest first, interleaved) and for the same order with the shapes
   reversed (smallest first).
2. One direct step (``cuda_graph=False``, after a warm-up step) under the
   profiler with Python stacks: the device ms of the ``direct_copy``
   kernels by the operator chain that launched them and the first frame
   of the port's code on its stack (none for autograd's backward, whose
   operator chain names the forward operation).

Prints the card's name and power limit first; ~1-2 min with the build.
"""

import gc
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import importlib.util

HERE = Path(__file__).resolve().parent
ROOT = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# this checkout's chip_smoke.py (ROOT may hold an older one)
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               HERE / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

COPY = "direct_copy"
PACKAGE = "nnacousticmodeling_tpu_torch"


def batch(dev):
    rng = np.random.default_rng(32)
    b, t, s = 128, 470, 50
    xs = torch.from_numpy(rng.standard_normal((b, t, cs.DIM)).astype(
        np.float32)).to(dev)
    lengths = rng.integers(300, t + 1, b)
    lengths[0] = t
    ys = torch.from_numpy(rng.integers(1, cs.PHONES + 1, (b, s))).to(dev)
    y_lens = rng.integers(42, s + 1, b)
    y_lens[0] = s
    return xs, lengths, ys, y_lens


def ctc_model_of(dev):
    from nnacousticmodeling_tpu_torch.models import get_network
    from nnacousticmodeling_tpu_torch.models.ctc import BiRNNCTC

    def ctc_model():
        return BiRNNCTC(get_network("lstm", cs.LAYERS, [cs.H_MAIN], 1,
                                    in_dim=cs.DIM, scan_impl="pallas",
                                    device=dev, seed=3), cs.PHONES, seed=3)
    return ctc_model


def copy_callers(dev, ctc_model, data):
    """(total direct_copy ms, launches, rows of (ms, launches, operator
    chain, the port's innermost Python frames)) of one profiled direct
    step. A kernel's operator is the one that launched it; its frames are
    the Python calls of the port whose span on the operator's thread
    holds the operator (none on autograd's backward thread)."""
    from torch.profiler import ProfilerActivity, profile

    from nnacousticmodeling_tpu_torch.models.ctc import make_ctc_train_step
    from nnacousticmodeling_tpu_torch.train import make_optimizer
    xs, lengths, ys, y_lens = data
    model = ctc_model()
    step = make_ctc_train_step(model, make_optimizer(
        "adam", 1e-3, model.parameters()), cuda_graph=False)
    gen = torch.Generator(device=dev).manual_seed(13)
    step(xs, lengths, ys, y_lens, gen)
    torch.cuda.synchronize()
    try:       # verbose: the recorded stacks of operators, where kept
        from torch._C._profiler import _ExperimentalConfig
        extra = dict(experimental_config=_ExperimentalConfig(verbose=True))
    except ImportError:
        extra = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=True, **extra) as prof:
        step(xs, lengths, ys, y_lens, gen)
        torch.cuda.synchronize()
    events = list(prof.events())
    py = [e for e in events if PACKAGE in e.name and ".py(" in e.name]
    rows = defaultdict(lambda: [0.0, 0])
    for ev in events:
        ks = [k for k in ev.kernels if COPY in k.name]
        if not ks:
            continue
        chain, e = [], ev
        while e is not None:
            chain.append(e.name)
            e = e.cpu_parent
        r = ev.time_range
        inside = sorted((p for p in py if p.thread == ev.thread
                         and p.time_range.start <= r.start
                         and p.time_range.end >= r.end),
                        key=lambda p: -p.time_range.start)
        frames = [p.name for p in inside]
        e = ev
        while e is not None and not frames:      # else the recorded stack
            frames = [f for f in e.stack if PACKAGE in f]
            e = e.cpu_parent
        frames = " < ".join(f.split(PACKAGE + "/")[-1] for f in frames[:3])
        key = (" < ".join(chain[:4]), frames or "(no frame of the port)")
        rows[key][0] += sum(k.duration for k in ks) / 1e3
        rows[key][1] += len(ks)
    out = sorted(((ms, n, c, f) for (c, f), (ms, n) in rows.items()),
                 reverse=True)
    return sum(r[0] for r in out), sum(r[1] for r in out), out


def main():
    if not torch.cuda.is_available():
        sys.exit("bench_ctc_step.py: needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}; package {ROOT}",
          flush=True)
    data = batch(dev)
    ctc_model = ctc_model_of(dev)
    reverse = dict(zip("ABCDEF", "FEDCBA"))
    orders = {"alone": "AAA", "largest first": cs.CTC_ORDER,
              "smallest first": "".join(reverse[k] for k in cs.CTC_ORDER)}
    alone = None                # GB the largest shape alone reserved
    for tag, order in orders.items():
        t0 = time.perf_counter()
        gb = []

        def on_capture(key, reserved):
            gb.append(reserved / 1e9)
            print(f"[memory] {tag}: {key} {cs.CTC_SHAPES[key]} captured, "
                  f"{gb[-1]:.3f} GB reserved", flush=True)
        try:
            cs.ctc_shape_steps(torch, np, dev, ctc_model, data, order,
                               on_capture=on_capture)
            done = "completed"
        except RuntimeError as e:          # OutOfMemoryError, or a capture
            if "out of memory" not in str(e):  # that ran out of it
                raise
            done = f"out of device memory: {str(e)[:200]}"
        gc.collect()
        torch.cuda.empty_cache()
        if alone is None:
            alone = gb[-1]
        print(f"[memory] {tag} ({order}): {done}; reserved GB after each "
              f"new shape's capture {gb}; {gb[-1] / alone:.3f}x the largest "
              f"shape alone ({time.perf_counter() - t0:.1f} s)", flush=True)
    total, n, rows = copy_callers(dev, ctc_model, data)
    print(f"[copies] one direct step: {COPY} kernels {total:.3f} ms device "
          f"in {n} launches; by caller (ms, launches, operator chain, the "
          f"port's frame):", flush=True)
    for ms, k, chain, frame in rows[:15]:
        print(f"  {ms:8.3f} {k:5d}  {chain}  @ {frame}", flush=True)


if __name__ == "__main__":
    main()
