#!/usr/bin/env python3
"""Time every tiling of the port's dW kernel (``csrc/dw_gemm.cuh``) on one
NVIDIA card, for each training backward's contraction at the training
shapes (T=20, B=128, H=1024), against cuBLAS bf16 ``matmul`` of the same
operands and the plain float32 version.

    python3 bench_dw_tilings.py

Times are device milliseconds per call (the profiler's kernel time over
20 calls), since a call is shorter than its Python host time. Each
tiling's result is checked against the plain version (max error over max
|dW|) and against a second call (same bits). Prints one line per family
and tiling, and the card's name and power limit.
"""

import subprocess
import sys
from pathlib import Path

T, B, H = 20, 128, 1024


def device_ms(torch, fn, reps=20):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total", 0)
             for ev in prof.key_averages()
             if getattr(ev, "device_type", None) == DeviceType.CUDA)
    return us / 1e3 / reps


def cases(torch, dev):
    """family -> (kernel wrapper, plain version, arguments, cuBLAS operand
    pairs (a, b) whose a^T b are the same products)."""
    from nnacousticmodeling_tpu_torch.ops import rnn_cuda as r
    g = torch.Generator().manual_seed(3)

    def res(width):
        return torch.rand(T, B, width * H, generator=g).to(dev, torch.bfloat16)

    def grad(width):
        return torch.randn(T, B, width * H, generator=g).to(dev,
                                                           torch.bfloat16)

    out = {}
    args = (res(7), grad(4))
    r2 = args[0].reshape(T * B, -1)
    out["lstm"] = (r.lstm_train_dw, r.lstm_train_dw_reference, args,
                   [(r2[:, 6 * H:].contiguous(), args[1].reshape(-1, 4 * H))])
    for name, has_w2 in (("gru", True), ("mgru", False)):
        args = (res(4), grad(2), grad(1) if has_w2 else None)
        r2 = args[0].reshape(T * B, -1)
        ops = [(r2[:, 3 * H:].contiguous(), args[1].reshape(-1, 2 * H))]
        if has_w2:
            rh = (r2[:, :H].float() * r2[:, 3 * H:].float()).to(
                torch.bfloat16).contiguous()
            ops.append((rh, args[2].reshape(-1, H)))
        out[name] = (r.gated_train_dw, r.gated_train_dw_reference, args, ops)
    args = (res(8), grad(4))
    r2, d2 = args[0].reshape(T * B, -1), args[1].reshape(-1, 4 * H)
    c_prev = r2[:, 5 * H:6 * H].contiguous()
    out["peephole"] = (
        r.peephole_train_dw, r.peephole_train_dw_reference, args,
        [(r2[:, 6 * H:7 * H].contiguous(), d2), (c_prev, d2[:, H:2 * H]),
         (c_prev, d2[:, 2 * H:3 * H]), (r2[:, 7 * H:].contiguous(),
                                        d2[:, 3 * H:])])
    return out


def as_list(x):
    return [t for t in (x if isinstance(x, tuple) else (x,)) if t is not None]


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("bench_dw_tilings.py: needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from nnacousticmodeling_tpu_torch import kernels
    from nnacousticmodeling_tpu_torch.ops import rnn_cuda as r
    kernels.build(["lstm_train", "gated_train", "peephole_train"])
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    plan = r.dw_plan
    for name, (fn, ref, args, ops) in cases(torch, dev).items():
        want = as_list(ref(*args))
        lib = device_ms(torch, lambda: [torch.matmul(a.T, b) for a, b in ops])
        plain = device_ms(torch, lambda: ref(*args))
        chosen = plan(name if name in ("lstm", "peephole") else "gated", H,
                      has_w2=name != "mgru")
        print(f"{name}: cuBLAS bf16 {lib:.4f} ms, plain {plain:.4f} ms; "
              f"chosen tiling {(chosen.tile_n, chosen.rows, chosen.stages)}"
              f" [{card}]", flush=True)
        for cfg in r.DW_CONFIGS:
            r.dw_plan = (lambda family, h, has_w2=True, config=None, c=cfg:
                         plan(family, h, has_w2, c))
            try:
                got = as_list(fn(*args))
                again = as_list(fn(*args))
                ms = device_ms(torch, lambda: fn(*args))
            except (RuntimeError, ValueError) as e:
                print(f"  {cfg}: not run ({e})", flush=True)
                continue
            finally:
                r.dw_plan = plan
            err = max(float((a - b).abs().max()) / float(b.abs().max())
                      for a, b in zip(got, want))
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            print(f"  {cfg}: {ms:.4f} ms ({ms / lib:.2f}x cuBLAS), error "
                  f"{err:.2e} of max |dW|, repeat bit-identical {same}",
                  flush=True)


if __name__ == "__main__":
    main()
