#!/usr/bin/env python3
"""Where a step of the persistent LSTM training kernels goes, on one
NVIDIA card: the device time of the ``lstm_train_forward`` and
``lstm_train_backward`` kernels (the profiler's kernel time, dW left out)
at H=1024 for T in (5, 20) and B in (32, 64, 128). With ``--peephole``
the same for the persistent PeepholeLSTM training kernels
(``peephole_train_forward``, ``peephole_train_backward``).

    python3 bench_lstm_train_steps.py [--peephole]

A step's time is the slope between T=5 and T=20, which leaves out a
launch's fixed cost (W_h's load, the first barrier, the tail). Each
reverse step, every block of the backward reads the bf16 dz of all 4H
columns for its rows from L2: B * 4H * 2 bytes times H/16 unit blocks,
16 MB at B=32 and 64 MB at B=128; each forward step reads h, a quarter of
that. The peephole kernels' blocks own 8 units: each reverse step reads
dz's 4H columns, B * 4H * 2 bytes times H/8 blocks, and each forward step
reads h and c_t, half of that. A least-squares line through the three
batch sizes splits a step into a part that grows with those bytes (its
slope is the rate at which the grid streams them) and a part that does
not (the barrier, the elementwise work, the latency of the step's
first loads). Prints one line per kernel and batch, one fit per kernel,
and the card's name and power limit.
"""

import subprocess
import sys
from pathlib import Path

H = 1024
TS = (5, 20)
BS = (32, 64, 128)
UNITS = {"lstm": 16, "peephole": 8}   # hidden units a block owns
REPS = 20


def kernel_ms(torch, fn, name):
    """Device milliseconds a call of the kernels whose name holds ``name``,
    over REPS calls after one warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total", 0)
             for ev in prof.key_averages()
             if getattr(ev, "device_type", None) == DeviceType.CUDA
             and name in ev.key)
    return us / 1e3 / REPS


def fit(xs, ys):
    """Least-squares line y = a + b x."""
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    b = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
         / sum((x - mx) ** 2 for x in xs))
    return my - b * mx, b


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("bench_lstm_train_steps.py: needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from nnacousticmodeling_tpu_torch import kernels
    from nnacousticmodeling_tpu_torch.ops import rnn_cuda as r
    net = "peephole" if "--peephole" in sys.argv[1:] else "lstm"
    kernels.build([f"{net}_train"])
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    g = torch.Generator().manual_seed(0)
    wh = (torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(dev)
    peeps = [(torch.randn(H, H, generator=g) / H ** 0.5).to(dev)
             for _ in range(3)] if net == "peephole" else []

    def calls(proj, c0, h0, dhs):
        """The forward and backward calls of the net's kernels."""
        if net == "lstm":
            _, res, _, _ = r.lstm_train_forward(proj, wh, c0, h0)
            return (lambda: r.lstm_train_forward(proj, wh, c0, h0),
                    lambda: r.lstm_train_backward(res, wh, dhs, c0, h0,
                                                  torch.float32))
        _, res, _, _ = r.peephole_train_forward(proj, wh, *peeps, c0, h0)
        return (lambda: r.peephole_train_forward(proj, wh, *peeps, c0, h0),
                lambda: r.peephole_train_backward(res, wh, *peeps, dhs, c0,
                                                  h0, torch.float32))
    steps = {"forward": {}, "backward": {}}
    for b in BS:
        ms = {"forward": [], "backward": []}
        for t in TS:
            proj = torch.randn(t, b, 4 * H, generator=g).to(dev)
            c0 = (torch.randn(b, H, generator=g) * 0.1).to(dev)
            h0 = (torch.randn(b, H, generator=g) * 0.1).to(dev)
            dhs = torch.randn(t, b, H, generator=g).to(dev)
            fwd, bwd = calls(proj, c0, h0, dhs)
            ms["forward"].append(kernel_ms(torch, fwd,
                                           f"{net}_train_fwd_persistent"))
            ms["backward"].append(kernel_ms(torch, bwd,
                                            f"{net}_train_bwd_persistent"))
        for kind, (short, long_) in ms.items():
            step_us = (long_ - short) * 1e3 / (TS[1] - TS[0])
            fixed_us = short * 1e3 - TS[0] * step_us
            mb = b * 4 * H * 2 * (H // UNITS[net]) / 1e6
            mb = mb if kind == "backward" else mb / (4 if net == "lstm"
                                                     else 2)
            steps[kind][mb] = step_us
            print(f"{net} {kind} B={b}: T={TS[0]} {short:.4f} ms, T={TS[1]} "
                  f"{long_:.4f} ms; {step_us:.2f} us a step, {fixed_us:.1f} "
                  f"us fixed; {mb:.1f} MB from L2 a step [{card}]",
                  flush=True)
    for kind, pts in steps.items():
        a, slope = fit(list(pts), list(pts.values()))
        print(f"{net} {kind}: a step = {a:.2f} us + MB / {1 / slope:.2f} TB/s "
              f"(least squares over B={', '.join(map(str, BS))}) [{card}]",
              flush=True)


if __name__ == "__main__":
    main()
