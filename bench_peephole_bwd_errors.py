#!/usr/bin/env python3
"""How far the peephole training backward lies from its plain version at
the card tests' wide sizes, and why, on one NVIDIA card.

    python3 bench_peephole_bwd_errors.py [ROOT]

For each size (T=3, float32 dproj, the inputs of
``tests/test_torch_cuda.py``) prints, relative to the largest value of
each tensor: the kernel's distance to the float32 plain version; the
kernel's and the float32 plain version's distances to a float64 twin of
it (the same bf16 roundings, float64 sums); the distance of dh0 and dW
to the plain products of the kernel's own bf16 dz; and how many bf16(dz)
differ from the plain version's, by reverse step. ROOT is the root of
another checkout of the port, whose kernels are then measured (an
earlier commit's, for one); by default this one.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SIZES = [(3, 128, 1024), (3, 4, 2048), (3, 300, 1024), (3, 100, 2120),
         (3, 4, 4096)]
NAMES = ("dproj", "dwh", "dpi", "dpf", "dpo", "dc0", "dh0")


def case(torch, t, b, h, dev):
    """tests/test_torch_cuda.py's _peep_case at float32 proj, and its
    backward's gradients."""
    g = torch.Generator().manual_seed(t * 1000 + b * 10 + h)
    proj = torch.randn(t, b, 4 * h, generator=g) * 0.5
    wh = torch.randn(h, 4 * h, generator=g) * min(0.1, 2.0 / h ** 0.5)
    peeps = [torch.randn(h, h, generator=g) * min(0.2, 4.0 / h ** 0.5)
             for _ in range(3)]
    c0 = torch.randn(b, h, generator=g) * 0.1
    h0 = torch.randn(b, h, generator=g) * 0.1
    g = torch.Generator().manual_seed(7)
    grads = [torch.randn(t, b, h, generator=g),
             torch.randn(b, h, generator=g), torch.randn(b, h, generator=g)]
    return [x.to(dev) for x in (proj, wh, *peeps, c0, h0, *grads)]


def twin64(torch, res, wh, pi, pf, po, dhs, dc, dh):
    """peephole_train_backward_reference with float64 sums: dproj, dW_h,
    dP_i, dP_f, dP_o, dc0, dh0."""
    def bf(x):
        return x.to(torch.bfloat16).double()
    t_len, _, eight_h = res.shape
    h_dim = eight_h // 8
    whf, pif, pff, pof = (bf(w) for w in (wh, pi, pf, po))
    dc, dh = dc.double(), dh.double()
    dproj, dzb = [], []
    for t in range(t_len - 1, -1, -1):
        a, ig, f, o, tc, c_prev = res[t, :, :6 * h_dim].double().split(
            h_dim, dim=1)
        dh_tot = dhs[t].double() + dh
        dz_o = (dh_tot * tc) * o * (1.0 - o)
        dc = dc + dh_tot * o * (1.0 - tc * tc) + bf(dz_o) @ pof.T
        dz = torch.cat([dc * ig * (1.0 - a * a), dc * a * ig * (1.0 - ig),
                        dc * c_prev * f * (1.0 - f), dz_o], dim=1)
        dproj.insert(0, dz)
        dzb.insert(0, bf(dz))
        dc = (dc * f + dzb[0][:, h_dim:2 * h_dim] @ pif.T
              + dzb[0][:, 2 * h_dim:3 * h_dim] @ pff.T)
        dh = dzb[0] @ whf.T
    r = res.reshape(-1, eight_h).double()
    d = torch.cat(dzb)
    c_prev = r[:, 5 * h_dim:6 * h_dim]
    return (torch.stack(dproj), r[:, 6 * h_dim:7 * h_dim].T @ d,
            c_prev.T @ d[:, h_dim:2 * h_dim],
            c_prev.T @ d[:, 2 * h_dim:3 * h_dim],
            r[:, 7 * h_dim:].T @ d[:, 3 * h_dim:], dc, dh)


def rel(got, want):
    want = want.double()
    return float((got.double() - want).abs().max() / want.abs().max())


def main():
    root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("bench_peephole_bwd_errors.py: needs a CUDA card")
    from nnacousticmodeling_tpu_torch.ops import rnn_cuda as r
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"kernels of {r.__file__} [{card}]", flush=True)
    dev = torch.device("cuda")
    for t, b, h in SIZES:
        proj, wh, pi, pf, po, c0, h0, dhs, dct, dht = case(torch, t, b, h,
                                                           dev)
        _, res, _, _ = r.peephole_train_forward_reference(
            proj, wh, pi, pf, po, c0, h0)
        bw = (res, wh, pi, pf, po, dhs, dct, dht)
        got = r.peephole_train_backward(*bw, torch.float32)
        ref = r.peephole_train_backward_reference(*bw, torch.float32)
        f64 = twin64(torch, *bw)
        dzb = got[0].to(torch.bfloat16)
        whb = wh.to(torch.bfloat16).double()
        own = ([rel(got[6], dzb[0].double() @ whb.T)]
               + [rel(k, w) for k, w in zip(
                   got[1:5], r.peephole_train_dw_reference(res, dzb))])
        flips = [int((dzb[s] != ref[0][s].to(torch.bfloat16)).sum())
                 for s in range(t - 1, -1, -1)]

        def row(xs, ws):
            return " ".join(f"{n} {rel(x, w):.2e}"
                            for n, x, w in zip(NAMES, xs, ws))
        print(f"T={t} B={b} H={h}: kernel vs plain {row(got, ref)}; "
              f"kernel vs float64 twin {row(got, f64)}; plain vs float64 "
              f"twin {row(ref, f64)}; vs the plain products of the "
              f"kernel's bf16 dz: dh0 {own[0]:.2e}, dW "
              f"{' '.join(f'{x:.2e}' for x in own[1:])}; bf16(dz) "
              f"differing from plain, reverse steps t={t - 1}..0: {flips} "
              f"of {dzb[0].numel()} [{card}]", flush=True)


if __name__ == "__main__":
    main()
