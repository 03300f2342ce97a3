"""Where a frame of the CTC loss kernels' warp route goes, on one card.

    python3 bench_ctc_loss_variants.py

Builds ``csrc/ctc_loss.cu`` with its measurement knobs into
``build/ctc_variants/`` (``-DCTC_WARPS``: warps a block;
``-DCTC_FWD_DEPTH`` / ``-DCTC_BWD_DEPTH``: the rings' stages;
``-DCTC_LEAVE_OUT``: parts left out, see the source)
and times each build's warp-route forward and backward (CUDA events, 50
calls after a warm-up) at chip_smoke.py phase 32's shape on seeded
log-probabilities (B=128, T=470, C=49, S=50, frame lengths 300-470, label
lengths 42-50), beside the packaged build's two routes and
``F.ctc_loss``, in turns (twice). A left-out build's results are wrong;
the packaged build's routes are held bit-equal first. Prints the card's
name and power limit first; ~1 min with the builds.
"""

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from nnacousticmodeling_tpu_torch import kernels  # noqa: E402
from nnacousticmodeling_tpu_torch.ops import ctc_cuda  # noqa: E402

OUT = HERE / "build" / "ctc_variants"
VARIANTS = {
    "packaged": [],
    "4 warps a block": ["-DCTC_WARPS=4"],
    "forward depth 8": ["-DCTC_FWD_DEPTH=8"],
    "backward depth 4": ["-DCTC_BWD_DEPTH=4"],
    "backward depth 16": ["-DCTC_BWD_DEPTH=16"],
    "no class sums": ["-DCTC_LEAVE_OUT=1"],
    "class sums, no chain walk": ["-DCTC_LEAVE_OUT=16"],
    "no blank sum": ["-DCTC_LEAVE_OUT=2"],
    "neither sum": ["-DCTC_LEAVE_OUT=3"],
    "no ring copies": ["-DCTC_LEAVE_OUT=4"],
    "no state rows (forward)": ["-DCTC_LEAVE_OUT=8"],
}
B, T, C, S = 128, 470, 49, 50


def build(name, flags):
    so = OUT / f"libctc_{abs(hash(name)) % 10 ** 8}.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, *flags, "-o",
                    str(so), str(kernels.CSRC / "ctc_loss.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    lib.ctc_loss_forward_warp.argtypes = ctc_cuda._FWD_ARGTYPES
    lib.ctc_loss_backward_warp.argtypes = ctc_cuda._BWD_ARGTYPES
    return lib


def ms(fn, reps=50):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    z.record()
    torch.cuda.synchronize()
    return a.elapsed_time(z) / reps


def main():
    if not torch.cuda.is_available():
        sys.exit("bench_ctc_loss_variants.py: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv),
                                           VARIANTS.items())))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    logp = torch.log_softmax(torch.from_numpy(2 * rng.standard_normal(
        (B, T, C)).astype(np.float32)), -1).to(dev)
    x_lens = rng.integers(300, T + 1, B)
    x_lens[0] = T
    y_lens = rng.integers(42, S + 1, B)
    labels = rng.integers(1, C, (B, S))
    for b in range(B):
        labels[b, y_lens[b]:] = 0
    lab = torch.from_numpy(labels).to(dev).int()
    xl = torch.from_numpy(x_lens).to(dev).int()
    yl = torch.from_numpy(y_lens).to(dev).int()
    grad = torch.full((B,), 1.0 / B, device=dev)
    runs = {r: ctc_cuda.ctc_loss_forward(logp, lab, xl, yl, route=r)
            for r in (None, "block")}
    torch.cuda.synchronize()
    valid = torch.arange(T, device=dev)[None, :] < xl[:, None]
    if not (torch.equal(runs[None][0], runs["block"][0]) and torch.equal(
            runs[None][1][valid], runs["block"][1][valid])):
        sys.exit("the packaged warp route differs from the block route")
    states = runs[None][1]
    loss = torch.empty(B, device=dev)
    st_out = torch.empty_like(states)
    dlp = torch.empty_like(logp)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (logp.data_ptr(), lab.data_ptr(), xl.data_ptr(), yl.data_ptr())
    lp_leaf = logp.detach().requires_grad_(True)
    xlist, ylist = [int(v) for v in x_lens], [int(v) for v in y_lens]
    lib_out = F.ctc_loss(lp_leaf.transpose(0, 1), lab.long(), xlist, ylist,
                         blank=0, reduction="none")
    for turn in range(2):
        rows = {}
        for route in (None, "block"):
            rows[f"package, {route or 'warp'} route"] = (
                ms(lambda: ctc_cuda.ctc_loss_forward(logp, lab, xl, yl,
                                                     route=route)),
                ms(lambda: ctc_cuda.ctc_loss_backward(
                    logp, lab, xl, yl, states, grad, route=route)))
        for name, lib in libs.items():
            def fwd():
                kernels.check(lib.ctc_loss_forward_warp(
                    *ptrs, loss.data_ptr(), st_out.data_ptr(), B, T, C, S,
                    stream), name)

            def bwd():
                kernels.check(lib.ctc_loss_backward_warp(
                    *ptrs, states.data_ptr(), grad.data_ptr(),
                    dlp.data_ptr(), B, T, C, S, stream), name)
            rows[name] = (ms(fwd), ms(bwd))
        rows["F.ctc_loss"] = (
            ms(lambda: F.ctc_loss(lp_leaf.transpose(0, 1), lab.long(),
                                  xlist, ylist, blank=0,
                                  reduction="none")),
            ms(lambda: torch.autograd.grad(lib_out, lp_leaf, grad,
                                           retain_graph=True)))
        print(f"turn {turn + 1}: ms forward / backward (us a frame of "
              f"T={T})", flush=True)
        for name, (f, b) in rows.items():
            print(f"  {name:30s} {f:.4f} ({1e3 * f / T:.3f}) / {b:.4f} "
                  f"({1e3 * b / T:.3f})", flush=True)


if __name__ == "__main__":
    main()
