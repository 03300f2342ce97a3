#!/usr/bin/env python3
"""How far the gated forwards lie from their plain version at the card
tests' wide sizes, for two weight scales, on one NVIDIA card: the
persistent training forward (``gated_train_forward``) and the per-step
``gated_scan``, each against ``gated_train_forward_reference``, and the
two against each other.

    python3 bench_gated_wide_errors.py

The inputs are ``tests/test_torch_cuda.py``'s ``_gated_case`` (T=3, proj
0.5 x N(0, 1), h0 0.1 x N(0, 1)) with w1 and w2 scaled by 0.2, the
small sizes' scale, and by min(0.2, 2 / sqrt(H)), which the card tests
take: at 0.2 and H >= 1024 the gates saturate and a bf16 rounding
flipped by float32 sums in another order moves the state by more than
the recurrence tolerance, in either kernel. Each distance is the largest
|a - b| beyond one bf16 ulp of b for bf16 hs (rtol 2**-7), over
max(1, max|b|). Prints one line per case and the card's name and power
limit.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SIZES = [(3, 128, 1024), (3, 4, 2048), (3, 300, 1024), (3, 4, 4240)]
KINDS = {"gru": (3, "tanh"), "mgru_r": (3, "relu"), "mgru": (2, "relu")}
RES_RTOL = 2.0 ** -7


def distance(got, want, ulp):
    scale = max(1.0, float(want.float().abs().max()))
    over = (got.float() - want.float()).abs() - ulp * want.float().abs()
    return float(over.max()) / scale


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("bench_gated_wide_errors.py: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from nnacousticmodeling_tpu_torch.ops import rnn_cuda as r
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    for kind, (gp, act) in KINDS.items():
        k = dict(kind=kind, activation=act)
        for t, b, h in SIZES:
            for dt in (torch.float32, torch.bfloat16):
                for tag, scale in (("0.2", 0.2),
                                   ("2/sqrt(H)", min(0.2, 2.0 / h ** 0.5))):
                    g = torch.Generator().manual_seed(t * 1000 + b * 10 + h)
                    proj = (torch.randn(t, b, gp * h, generator=g)
                            * 0.5).to(dt)
                    w1 = torch.randn(h, 2 * h, generator=g) * scale
                    w2 = (None if kind == "mgru"
                          else torch.randn(h, h, generator=g) * scale)
                    h0 = torch.randn(b, h, generator=g) * 0.1
                    args = [None if x is None else x.to(dev)
                            for x in (proj, w1, w2, h0)]
                    hs, _, ht = r.gated_train_forward(*args, **k)
                    ht_s, hs_s = r.gated_scan(*args, **k)
                    hs_r, _, ht_r = r.gated_train_forward_reference(*args,
                                                                    **k)
                    ulp = RES_RTOL if dt == torch.bfloat16 else 0.0
                    print(f"{kind} T={t} B={b} H={h} {str(dt)[6:]} weights "
                          f"x {tag}: max|hs| "
                          f"{float(hs_r.float().abs().max()):.3g}; kernel - "
                          f"plain hs {distance(hs, hs_r, ulp):.2e}, h_T "
                          f"{distance(ht, ht_r, 0.0):.2e}; gated_scan - "
                          f"plain hs {distance(hs_s, hs_r, ulp):.2e}, h_T "
                          f"{distance(ht_s, ht_r, 0.0):.2e}; kernel - "
                          f"gated_scan hs {distance(hs, hs_s, 2 * ulp):.2e}",
                          flush=True)


if __name__ == "__main__":
    main()
