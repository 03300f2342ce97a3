#!/usr/bin/env python3
"""How far the gated kernels lie from their plain versions at the card
tests' wide sizes and at the serving shape, and why, on one NVIDIA card.

    python3 bench_gated_wide_errors.py

The inputs are ``tests/test_torch_cuda.py``'s ``_gated_case`` (proj 0.5
x N(0, 1), h0 0.1 x N(0, 1), w1 and w2 scaled by min(0.2, 2 / sqrt(H)),
which the card tests take; at the small sizes' 0.2 and H >= 1024 the
gates saturate and a bf16 rounding flipped by float32 sums in another
order moves the state by more than the recurrence tolerance). Prints,
for each kind:

- the training forward at T=3 and the wide sizes, f32 and bf16 proj:
  its distance to the plain version (beyond one bf16 ulp, rtol 2**-7,
  for bf16 hs), and whether ``gated_scan`` gives the same bits;
- ``gated_scan`` at the serving shape (T=512, B=128, H=1024), on these
  inputs and on ``chip_smoke.py`` phase 12's (proj N(0, 1), weights
  N(0, 1) / sqrt(H), h0 = 0; the card tests' ``_serving_case``): its
  distance to the plain version, and the plain version's to a float64
  twin of it (the same bf16 roundings, float64 sums), which shows how
  far 512 steps carry a difference in the order of the sums;
- the training backward at T=3 and the wide sizes, float32 dproj: each
  tensor's distance to the plain version, the kernel's and the plain
  version's to a float64 twin, and dh0's and dW's to the plain products
  of the kernel's own bf16 pair and dc.

Distances are over max(1, max|plain|) for the forwards and over
max|plain| for the backward. Ends with the card's name and power limit.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SIZES = [(3, 128, 1024), (3, 4, 2048), (3, 300, 1024), (3, 4, 4240)]
SERVING = (512, 128, 1024)
KINDS = {"gru": (3, "tanh"), "mgru_r": (3, "relu"), "mgru": (2, "relu")}
RES_RTOL = 2.0 ** -7


def distance(got, want, ulp=0.0):
    scale = max(1.0, float(want.float().abs().max()))
    over = (got.double() - want.double()).abs() - ulp * want.double().abs()
    return float(over.max()) / scale


def rel(got, want):
    want = want.double()
    return float((got.double() - want).abs().max() / want.abs().max())


def case(torch, kind, t, b, h, dt, dev):
    """tests/test_torch_cuda.py's _gated_case, and its backward's
    gradients (float32)."""
    gp = KINDS[kind][0]
    g = torch.Generator().manual_seed(t * 1000 + b * 10 + h)
    proj = (torch.randn(t, b, gp * h, generator=g) * 0.5).to(dt)
    scale = min(0.2, 2.0 / h ** 0.5)
    w1 = torch.randn(h, 2 * h, generator=g) * scale
    w2 = None if kind == "mgru" else torch.randn(h, h, generator=g) * scale
    h0 = torch.randn(b, h, generator=g) * 0.1
    g = torch.Generator().manual_seed(7)
    dhs = torch.randn(t, b, h, generator=g)
    dht = torch.randn(b, h, generator=g)
    return [None if x is None else x.to(dev)
            for x in (proj, w1, w2, h0, dhs, dht)]


def serving_case(torch, kind, dt, dev):
    """tests/test_torch_cuda.py's _serving_case: chip_smoke.py phase 12's
    inputs at the serving shape."""
    t, b, h = SERVING
    gp = KINDS[kind][0]
    g = torch.Generator().manual_seed(20 + gp)
    w1 = torch.randn(h, 2 * h, generator=g) / h ** 0.5
    w2 = None if kind == "mgru" else torch.randn(h, h, generator=g) / h ** 0.5
    proj = torch.randn(t, b, gp * h, generator=g).to(dt)
    return [None if x is None else x.to(dev)
            for x in (proj, w1, w2, torch.zeros(b, h))]


def bf(torch, x):
    return x.to(torch.bfloat16).double()


def scan64(torch, r, proj, w1, w2, h0, kind, act):
    """gated_scan_reference with float64 sums: hs, h_T."""
    w1f = bf(torch, w1)
    w2f = None if w2 is None else bf(torch, w2)
    p = bf(torch, proj)
    h, hs = h0.double(), []
    for t in range(p.shape[0]):
        h = r._gated_step(kind, act, p[t], bf(torch, h) @ w1f, h,
                          lambda x: bf(torch, x) @ w2f)[3]
        hs.append(h)
    return torch.stack(hs), h


def bwd64(torch, r, res, w1, w2, dhs, dht, kind, act):
    """gated_train_backward_reference with float64 sums: dproj, dW1, dW2
    (None for mgru), dh0."""
    h_dim = w1.shape[0]
    w1f = bf(torch, w1)
    w2f = None if w2 is None else bf(torch, w2)
    dh = dht.double()
    dproj, pairs, dcs = [], [], []
    for t in range(res.shape[0] - 1, -1, -1):
        rg, z, hb, hp = res[t].double().split(h_dim, dim=1)
        dh_tot = dhs[t].double() + dh
        dh_new = dh_tot * (1.0 - z)
        dzpre = dh_tot * (hb - hp) * z * (1.0 - z)
        dcpre = dh_tot * z * r._act_grad(act, hb).double()
        if w2 is not None:
            dcs.insert(0, bf(torch, dcpre))
            drh = dcs[0] @ w2f.T
            dh_new = dh_new + drh * rg
            drpre = drh * hp * rg * (1.0 - rg)
        if kind == "gru":            # proj [r, z, c], w1 [r | z]
            cols, pair = (drpre, dzpre, dcpre), (drpre, dzpre)
        elif kind == "mgru_r":       # proj [z, c, r], w1 [z | r]
            cols, pair = (dzpre, dcpre, drpre), (dzpre, drpre)
        else:                        # proj [z, c], w1 [z | c]
            cols, pair = (dzpre, dcpre), (dzpre, dcpre)
        dproj.insert(0, torch.cat(cols, dim=1))
        pairs.insert(0, bf(torch, torch.cat(pair, dim=1)))
        dh = dh_new + pairs[0] @ w1f.T
    r2 = res.reshape(-1, 4 * h_dim).double()
    dw1 = r2[:, 3 * h_dim:].T @ torch.cat(pairs)
    dw2 = (None if w2 is None else
           bf(torch, r2[:, :h_dim] * r2[:, 3 * h_dim:]).T @ torch.cat(dcs))
    return torch.stack(dproj), dw1, dw2, dh


def own_pair_dc(torch, kind, dproj, h):
    """The bf16 pair and dc of a float32 dproj, in w1's column order."""
    d = dproj.to(torch.bfloat16)
    if kind == "gru":
        return d[..., :2 * h], d[..., 2 * h:]
    if kind == "mgru_r":
        return torch.cat([d[..., :h], d[..., 2 * h:]], -1), d[..., h:2 * h]
    return d, None


def dh0_of_pair(torch, res, w1, w2, dhs, dht, pair, dc):
    """dh0 of the plain reverse loop whose products take the given bf16
    pair and dc (float64 sums)."""
    h = w1.shape[0]
    w1f = bf(torch, w1)
    w2f = None if w2 is None else bf(torch, w2)
    dh = dht.double()
    for t in range(res.shape[0] - 1, -1, -1):
        rg, z, _, _ = res[t].double().split(h, dim=1)
        dh_new = (dhs[t].double() + dh) * (1.0 - z)
        if w2 is not None:
            dh_new = dh_new + (dc[t].double() @ w2f.T) * rg
        dh = dh_new + pair[t].double() @ w1f.T
    return dh


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("bench_gated_wide_errors.py: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from nnacousticmodeling_tpu_torch.ops import rnn_cuda as r
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    names = ("dproj", "dW1", "dW2", "dh0")
    for kind, (gp, act) in KINDS.items():
        k = dict(kind=kind, activation=act)
        for t, b, h in SIZES:
            for dt in (torch.float32, torch.bfloat16):
                proj, w1, w2, h0, _, _ = case(torch, kind, t, b, h, dt, dev)
                hs, _, ht = r.gated_train_forward(proj, w1, w2, h0, **k)
                ht_s, hs_s = r.gated_scan(proj, w1, w2, h0, **k)
                hs_r, _, ht_r = r.gated_train_forward_reference(
                    proj, w1, w2, h0, **k)
                ulp = RES_RTOL if dt == torch.bfloat16 else 0.0
                print(f"{kind} forward T={t} B={b} H={h} {str(dt)[6:]}: "
                      f"kernel - plain hs {distance(hs, hs_r, ulp):.2e}, "
                      f"h_T {distance(ht, ht_r):.2e}; gated_scan bit-equal "
                      f"{torch.equal(hs, hs_s) and torch.equal(ht, ht_s)}",
                      flush=True)
        t, b, h = SERVING
        for inputs in ("card tests'", "serving"):
            for dt in (torch.float32, torch.bfloat16):
                proj, w1, w2, h0 = (
                    case(torch, kind, t, b, h, dt, dev)[:4]
                    if inputs == "card tests'"
                    else serving_case(torch, kind, dt, dev))
                ht, hs = r.gated_scan(proj, w1, w2, h0, **k)
                ht_r, hs_r = r.gated_scan_reference(proj, w1, w2, h0, **k)
                hs64, ht64 = scan64(torch, r, proj, w1, w2, h0, kind, act)
                ulp = RES_RTOL if dt == torch.bfloat16 else 0.0
                print(f"{kind} gated_scan T={t} B={b} H={h} "
                      f"{str(dt)[6:]}, {inputs} inputs: kernel - plain hs "
                      f"{distance(hs, hs_r):.2e} (beyond one bf16 ulp "
                      f"{distance(hs, hs_r, RES_RTOL):.2e}), h_T "
                      f"{distance(ht, ht_r):.2e}; plain - float64 twin hs "
                      f"{distance(hs_r, hs64, ulp):.2e}, h_T "
                      f"{distance(ht_r, ht64):.2e}; kernel - float64 twin "
                      f"hs {distance(hs, hs64, ulp):.2e}", flush=True)
                del proj, hs, hs_r, hs64
        for t, b, h in SIZES:
            proj, w1, w2, h0, dhs, dht = case(torch, kind, t, b, h,
                                              torch.float32, dev)
            _, res, _ = r.gated_train_forward_reference(proj, w1, w2, h0,
                                                        **k)
            bw = (res, w1, w2, dhs, dht)
            got = r.gated_train_backward(*bw, torch.float32, **k)
            ref = r.gated_train_backward_reference(*bw, torch.float32, **k)
            f64 = bwd64(torch, r, *bw, kind, act)
            pair, dc = own_pair_dc(torch, kind, got[0], h)
            own = r.gated_train_dw_reference(
                res, pair.contiguous(), None if dc is None
                else dc.contiguous())
            own_dh0 = dh0_of_pair(torch, *bw, pair, dc)

            def row(xs, ws):
                return " ".join(f"{n} {rel(x, w):.2e}" for n, x, w in
                                zip(names, xs, ws) if w is not None)
            print(f"{kind} backward T={t} B={b} H={h}: kernel vs plain "
                  f"{row(got, ref)}; kernel vs float64 twin {row(got, f64)};"
                  f" plain vs float64 twin {row(ref, f64)}; vs the plain "
                  f"products of the kernel's bf16 pair and dc: dh0 "
                  f"{rel(got[3], own_dh0):.2e}, "
                  + " ".join(f"{n} {rel(x, w):.2e}" for n, x, w in
                             zip(names[1:3], got[1:3], own) if w is not None),
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
