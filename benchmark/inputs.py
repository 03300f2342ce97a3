"""Everything a run feeds the system, made from ``--seed``.

The sizes of the work are the same for every seed: utterance lengths are
fixed quantiles of the configured log-normal, and a seed only permutes
their order and draws the values (features, targets, weights, the HMM
image, the log priors). So two seeds differ in their numbers and never
in how much work they ask for.

Weights, features and targets are drawn on the run's device with one
``torch.Generator`` in a few large calls; the image and the orders come
from a numpy generator on the host. Both sides of the comparison (the
system and the plain reference) receive the same arrays.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch


def seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 63-bit seeds derived from the run's seed."""
    ss = np.random.SeedSequence(int(seed) % 2 ** 63)
    return [int(s) for s in ss.generate_state(n, np.uint64) % (2 ** 63)]


def utterance_lengths(n: int, median: float, sigma: float, lo: int,
                      hi: int) -> np.ndarray:
    """``n`` frame counts at the mid-quantiles ``(i + 0.5) / n`` of a
    log-normal with this median and shape, rounded and clipped to
    [lo, hi]; ascending. No seed: every run gets the same lengths."""
    from statistics import NormalDist
    q = (np.arange(n) + 0.5) / n
    z = np.array([NormalDist().inv_cdf(float(p)) for p in q])
    return np.clip(np.rint(median * np.exp(sigma * z)), lo, hi).astype(
        np.int64)


def device_generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def param_shapes(model: dict) -> Dict[str, tuple]:
    """The network's parameters by name (``cells.<l>.<leaf>``, then
    ``out.w``, ``out.b``) and shape: dense weights (in, out), the LSTM's
    gates packed a, i, f, o, the GRU's input projection r, z, candidate."""
    d, h, c = model["in_dim"], model["units"], model["num_classes"]
    shapes: Dict[str, tuple] = {}
    for layer in range(model["layers"]):
        pre = f"cells.{layer}."
        if model["network"] == "lstm":
            shapes.update({pre + "wx": (d, 4 * h), pre + "wh": (h, 4 * h),
                           pre + "b": (4 * h,)})
        elif model["network"] == "gru":
            shapes.update({pre + "wx": (d, 3 * h), pre + "bx": (3 * h,),
                           pre + "wh_rz": (h, 2 * h), pre + "wh_c": (h, h)})
        else:
            raise ValueError(f"no parameters for {model['network']!r}")
        d = h
    shapes.update({"out.w": (h, c), "out.b": (c,)})
    return shapes


def model_weights(model: dict, device: torch.device, seed: int
                  ) -> Dict[str, torch.Tensor]:
    """Float32 weights under the system's parameter names: every matrix
    normal over sqrt(fan in) (its first dimension), drawn in one call;
    every vector zero, except the LSTM's forget-gate bias, which is 1
    (Chainer's ``forget_bias_init``)."""
    shapes, network = param_shapes(model), model["network"]
    gen = device_generator(device, seed)
    mats = {k: s for k, s in shapes.items() if len(s) >= 2}
    total = sum(math.prod(s) for s in mats.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, pos = {}, 0
    for name, shape in mats.items():
        n = math.prod(shape)
        out[name] = flat[pos:pos + n].view(shape) / math.sqrt(shape[0])
        pos += n
    for name, shape in shapes.items():
        if len(shape) >= 2:
            continue
        v = torch.zeros(shape, device=device)
        if network == "lstm" and name.endswith(".b"):
            h = shape[0] // 4
            v[2 * h:3 * h] = 1.0
        out[name] = v
    return {k: out[k] for k in shapes}


def log_priors(num_classes: int, device: torch.device, seed: int
               ) -> torch.Tensor:
    """Log pdf priors: normalised counts, as a training set's alignment
    gives them, every class at least 1 count in 10,000."""
    gen = device_generator(device, seed)
    counts = torch.rand(num_classes, generator=gen, device=device) + 1e-4
    return torch.log(counts / counts.sum())


# ---------------------------------------------------------------------------
# the decoding image
# ---------------------------------------------------------------------------

@dataclass
class Image:
    """The arrays of a triphone-HMM decoding image (the native
    recognizer's layout): biphone (a, b) is a*P + b, triphone (a-b+c)
    enters from biphone (a, b) and leaves into (b, c)."""
    num_phones: int
    num_biphones: int
    num_triphones: int
    num_states: int
    start_idxs: np.ndarray
    end_idxs: np.ndarray
    biphone_in: np.ndarray
    biphone_out: np.ndarray
    state_idxs: np.ndarray
    tp_selfloop: np.ndarray
    tp_transition: np.ndarray
    out_offsets: np.ndarray
    out_values: np.ndarray
    lm: np.ndarray
    phone_names: List[str]


def synthetic_image(num_phones: int, num_states: int, seed: int) -> Image:
    """A full-context triphone cube with random tied pdf ids and
    transition probabilities tied to the pdf (as Kaldi ties them), a
    random bigram LM over biphones; the start biphone of phone p is
    (p, p), its end biphone (p, 0)."""
    rng = np.random.default_rng(seed)
    P = num_phones
    a, b, c = (g.reshape(-1) for g in np.meshgrid(
        np.arange(P), np.arange(P), np.arange(P), indexing="ij"))
    t3 = P ** 3
    biphone_in = (a * P + b).astype(np.int32)
    biphone_out = (b * P + c).astype(np.int32)
    state_idxs = rng.integers(0, num_states, size=(t3, 3)).astype(np.int32)
    self_p = rng.uniform(0.3, 0.8, size=num_states)[state_idxs]
    order = np.argsort(biphone_out, kind="stable").astype(np.int32)
    offsets = np.zeros(P * P + 1, dtype=np.int32)
    np.cumsum(np.bincount(biphone_out, minlength=P * P), out=offsets[1:])
    lm = rng.uniform(-3.0, -0.1, size=P * P).astype(np.float32)
    return Image(
        num_phones=P, num_biphones=P * P, num_triphones=t3,
        num_states=num_states,
        start_idxs=np.arange(P, dtype=np.int32) * (P + 1),
        end_idxs=np.arange(P, dtype=np.int32) * P,
        biphone_in=biphone_in, biphone_out=biphone_out,
        state_idxs=state_idxs,
        tp_selfloop=np.log(self_p).astype(np.float32),
        tp_transition=np.log(1.0 - self_p).astype(np.float32),
        out_offsets=offsets, out_values=order, lm=lm,
        phone_names=[f"p{int(x)}" for x in b])


# ---------------------------------------------------------------------------
# utterances
# ---------------------------------------------------------------------------

def time_delay(x: np.ndarray, y: np.ndarray, offsets: np.ndarray, k: int):
    """The recipe's ``--timedelay k`` on a corpus: each utterance's input
    edge-padded k frames on the right, its targets k frames on the left
    (the first target repeated), lengths grown by k."""
    if k == 0:
        return x, y, offsets
    lengths = np.diff(offsets)
    new_off = np.zeros_like(offsets)
    new_off[1:] = np.cumsum(lengths + k)
    src = np.concatenate([np.r_[np.arange(o, o + n), np.full(k, o + n - 1)]
                          for o, n in zip(offsets[:-1], lengths)])
    tgt = np.concatenate([np.r_[np.full(k, o), np.arange(o, o + n)]
                          for o, n in zip(offsets[:-1], lengths)])
    return x[src], y[tgt], new_off


def corpus(lengths: np.ndarray, dim: int, num_classes: int,
           device: torch.device, seed: int):
    """Host arrays of a corpus: features (N, dim) float32, unit normal,
    per-frame targets (N,) int32, and offsets; drawn on the device."""
    gen = device_generator(device, seed)
    n = int(lengths.sum())
    x = torch.randn(n, dim, generator=gen, device=device)
    y = torch.randint(0, num_classes, (n,), generator=gen, device=device,
                      dtype=torch.int32)
    offsets = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return x.cpu().numpy(), y.cpu().numpy(), offsets
