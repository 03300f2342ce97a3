"""Serving traffic: a test set decoded batch after batch through the
system's fused path, in a closed loop.

Parameters (the traffic mix's file): ``utterances`` and their length
distribution (``median``, ``sigma``, ``min_frames``, ``max_frames``;
``inputs.utterance_lengths``), ``batch`` (the set is sorted longest
first and cut into batches of this many, each padded to its longest
utterance plus the model's time delay), ``queued`` (batches in flight:
when one batch's segments are on the host the next is sent), and
``check_batches`` (how many finished batches the comparison takes,
the longest batch always among them).

The entry the window drives, for each batch: its features and lengths
from pinned host memory to the device; ``net.apply_sequence`` on the
kernel route; ``log_softmax(y - log_priors)``; the time-delay trim
(the first ``timedelay`` outputs dropped, the last ``timedelay`` frames
of each utterance zero: the recipe's posterior quirk); the decoder's
``decode_arrays_fn``; the segments back to pinned host memory.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import inputs
from benchmark.common import Outcome, Work, stamp
from benchmark.reference import nets as ref_nets
from benchmark.reference.viterbi import ReferenceDecoder
from benchmark.roofline import image_table_bytes
from benchmark.trace import WINDOW, Trace, session, span


#: frames at the start of each utterance whose posteriors
#: ``posterior_gap_start`` averages. Over a whole utterance the system's
#: posteriors and the reference's drift apart by about the same amount
#: whether the reference's float32 products run in float32 or in TF32:
#: every layer rounds its input projection to bf16, so a one-ulp
#: difference anywhere grows through the layers and the frames to the
#: size of a bf16 rounding. In the first frames it has not grown yet,
#: and TF32's error (mostly the output layer's) stands out: mean gap 3-4x
#: the float32 system's. ``posterior_gap_widest`` holds every frame.
START_FRAMES = 4


@dataclass
class _Batch:
    lengths: np.ndarray          # frames of each utterance
    x_host: torch.Tensor         # (n, T + delay, dim), pinned on a card
    lens_host: torch.Tensor      # (n,) int32
    audio_s: float


@dataclass
class _Pending:
    index: int
    round: int
    sent: float
    event: object
    segs: torch.Tensor
    counts: torch.Tensor
    lp: Optional[torch.Tensor]


def _pinned(t: torch.Tensor) -> torch.Tensor:
    return t.pin_memory() if torch.cuda.is_available() else t


def _test_set(traffic: dict, model: dict, dev, seed: int) -> List[_Batch]:
    lengths = inputs.utterance_lengths(
        traffic["utterances"], traffic["median"], traffic["sigma"],
        traffic["min_frames"], traffic["max_frames"])[::-1].copy()
    delay, dim = model["timedelay"], model["in_dim"]
    gen = inputs.device_generator(dev, seed)
    feats = torch.randn(int(lengths.sum()), dim, generator=gen, device=dev)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    out = []
    for beg in range(0, len(lengths), traffic["batch"]):
        lens = lengths[beg:beg + traffic["batch"]]
        offs = torch.as_tensor(offsets[beg:beg + len(lens)], device=dev)
        n_t = int(lens.max()) + delay
        t = torch.arange(n_t, device=dev)
        ln = torch.as_tensor(lens, device=dev)
        # utterance frames, then its last frame repeated `delay` times
        # (the time delay's edge padding), then zeros
        src = offs[:, None] + torch.minimum(t[None], ln[:, None] - 1)
        x = feats[src] * (t[None] < ln[:, None] + delay)[..., None]
        out.append(_Batch(lens, _pinned(x.cpu()), _pinned(
            torch.as_tensor(lens, dtype=torch.int32)),
            float(lens.sum()) / 100.0))
    return out


@dataclass
class Inputs:
    weights: Dict[str, torch.Tensor]
    image: inputs.Image
    log_priors: torch.Tensor
    batches: List[_Batch]
    checked: set            # the batches the comparison takes ...
    check_round: int        # ... from this pass over the set


def make_inputs(cell, seed: int, dev) -> Inputs:
    """The run's inputs from its seed: the same for the system and the
    reference, and for the control."""
    model, traffic = cell.model, cell.traffic
    s_img, s_w, s_x, s_ap, s_pick = inputs.seeds(seed, 5)
    batches = _test_set(traffic, model, dev, s_x)
    rng = np.random.default_rng(s_pick)
    others = rng.permutation(np.arange(1, len(batches)))
    return Inputs(
        weights=inputs.model_weights(model, dev, s_w),
        image=inputs.synthetic_image(cell.config["decoder"]["phones"],
                                     model["num_classes"], s_img),
        log_priors=inputs.log_priors(model["num_classes"], dev, s_ap),
        batches=batches,
        checked={0, *others[:traffic["check_batches"] - 1].tolist()},
        check_round=int(rng.integers(0, 2)))


def run(cell, seed: int, seconds: float, traced: bool, dev, setup_t0: float,
        now=time.time):
    from nnacousticmodeling_tpu_torch import kernels
    from nnacousticmodeling_tpu_torch.decoder.image import HmmImage
    from nnacousticmodeling_tpu_torch.decoder.viterbi import ViterbiDecoder
    from nnacousticmodeling_tpu_torch.models import get_network
    from nnacousticmodeling_tpu_torch.ops.numerics import log_softmax

    model, traffic, dec_cfg = cell.model, cell.traffic, cell.config["decoder"]
    on_card = dev.type == "cuda"

    # ---- set-up: model, decoder, inputs --------------------------------
    stamp(setup_t0, "torch and the system imported")
    ins = make_inputs(cell, seed, dev)
    weights, image, ap, batches = (ins.weights, ins.image, ins.log_priors,
                                   ins.batches)
    checked, check_round = ins.checked, ins.check_round
    stamp(setup_t0, "inputs made")
    net = get_network(model["network"], model["layers"], [model["units"]],
                      model["num_classes"], dropout=[cell.config["dropout"]],
                      in_dim=model["in_dim"], scan_impl="pallas", device=dev)
    net.load_state_dict(weights)
    stamp(setup_t0, "network built")
    decoder = ViterbiDecoder(HmmImage(**vars(image)), pip=dec_cfg["pip"],
                             lmw=dec_cfg["lmw"], device=dev)
    decode = decoder.decode_arrays_fn()
    stamp(setup_t0, "decoder built")
    delay = model["timedelay"]
    t_max = max(int(b.lengths.max()) for b in batches)
    width = traffic["batch"]
    slots = [(_pinned(torch.zeros(width * t_max * 3, dtype=torch.int32)),
              _pinned(torch.zeros(width, dtype=torch.int64)))
             for _ in range(traffic["queued"])]

    def send(index: int, rnd: int, slot: int, keep: bool) -> _Pending:
        b = batches[index]
        sent = now()
        with span("bench.h2d"):
            x = b.x_host.to(dev, non_blocking=True)
            lens = b.lens_host.to(dev, non_blocking=True)
        with torch.inference_mode():
            with span("bench.network"):
                y, _ = net.apply_sequence(x)
                lp = log_softmax(y - ap, dim=-1)
            with span("bench.delay_trim"):
                lp = delay_trim(lp, lens, delay)
            with span("bench.decode"):
                segs, counts = decode(lp, lens)
        with span("bench.d2h"):
            seg_buf, cnt_buf = slots[slot]
            seg_h = seg_buf[:segs.numel()].view(segs.shape)
            cnt_h = cnt_buf[:counts.numel()]
            seg_h.copy_(segs, non_blocking=True)
            cnt_h.copy_(counts, non_blocking=True)
            ev = torch.cuda.Event() if on_card else None
            if ev is not None:
                ev.record()
        return _Pending(index, rnd, sent, ev, seg_h, cnt_h,
                        lp if keep else None)

    def loop(stop_after_s: Optional[float], rounds: Optional[int]):
        """The closed loop: ``queued`` batches in flight, the next sent
        when one's segments are on the host, until ``stop_after_s`` has
        passed (or ``rounds`` passes are sent). Returns each batch's
        (index, round, sent, done) and the checked batches' outputs."""
        order = ((r, i) for r in itertools.count()
                 for i in range(len(batches)))
        free = deque(range(traffic["queued"]))
        flight: deque = deque()
        done: List[tuple] = []
        kept: Dict[int, tuple] = {}
        t0 = now()
        closed = None

        def submit():
            r, i = next(order)
            if rounds is not None and r >= rounds:
                return False
            slot = free.popleft()
            flight.append((slot, send(i, r, slot,
                                      r == check_round and i in checked)))
            return True

        for _ in range(traffic["queued"]):
            submit()
        while flight:
            slot, p = flight.popleft()
            with span("bench.wait"):
                if p.event is not None:
                    p.event.synchronize()
            t = now()
            done.append((p.index, p.round, p.sent, t))
            if p.lp is not None:
                n = len(batches[p.index].lengths)
                kept[p.index] = (p.lp, _segment_lists(
                    p.segs.numpy(), p.counts.numpy()[:n]))
            free.append(slot)
            # the window closes once its time is up and the batches the
            # comparison takes are back (at 20 s, long after)
            if (closed is None and stop_after_s is not None
                    and t - t0 >= stop_after_s and len(kept) == len(checked)):
                closed = t
            if closed is None:
                submit()
        return t0, closed, done, kept

    # warm-up: every batch shape once, through the window's own loop
    # (kernels built, decoder pack factors cached, the allocator's
    # blocks held as the window holds them)
    loop(None, rounds=1)
    if on_card:
        torch.cuda.synchronize()
    stamp(setup_t0, "warm-up pass done")
    setup_s = now() - setup_t0
    kernels.reset_launches()

    # ---- the window -----------------------------------------------------
    with session(traced) as prof:
        with span(WINDOW):
            t0, closed, done, kept = loop(seconds, rounds=None)
            if on_card:
                torch.cuda.synchronize()
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    in_window = [d for d in done if d[3] <= closed]
    audio = sum(batches[i].audio_s for i, _, _, _ in in_window)
    latency_ms = [1e3 * (t - s) for _, _, s, t in done]
    metrics = {
        "decode_audio_s_per_s": audio / (closed - t0),
        "decode_batch_p95_ms": float(np.percentile(latency_ms, 95)),
        "setup_s": setup_s,
    }
    n_batches = len(done)
    lens_all = [batches[i].lengths for i, _, _, _ in done]
    frames = int(sum(int(x.sum()) for x in lens_all))
    work = Work(
        model=model, batches=n_batches,
        net_frames=frames + delay * sum(len(x) for x in lens_all),
        rec_calls=n_batches, decode_frames=frames, decode_calls=n_batches,
        triphones=image.num_triphones, num_states=image.num_states,
        table_bytes=image_table_bytes(image), extra={"launches": launches})
    if traced:
        work.trace = Trace(prof)

    # ---- the comparison, the system's state freed first ----------------
    del net, decoder, decode, slots
    if on_card:
        torch.cuda.empty_cache()
    if set(kept) != checked:
        # a checked batch never came back: nothing to compare is a failure
        compared = dict.fromkeys(COMPARED)
    else:
        compared = compare(model, dec_cfg, ins, kept, dev)
    return Outcome(metrics=metrics, compared=compared, attempted=n_batches,
                   failed=0, work=work, memory_peak_bytes=peak)


def delay_trim(lp: torch.Tensor, lens: torch.Tensor, delay: int
               ) -> torch.Tensor:
    """(n, T + delay, C) -> (n, T, C): the first ``delay`` outputs dropped
    and each utterance's last ``delay`` frames zero."""
    n_t = lp.shape[1] - delay
    tail = (torch.arange(n_t, device=lp.device)[None]
            >= (lens - delay)[:, None].long())
    return lp[:, delay:].masked_fill(tail[..., None], 0.0)


def _segment_lists(segs: np.ndarray, counts: np.ndarray):
    """The decoder's (U, T, 3) rows, last segment first, as each
    utterance's (begin, end, triphone) list, first to last."""
    return [[tuple(int(v) for v in segs[u, i])
             for i in range(int(counts[u]) - 1, -1, -1)]
            for u in range(len(counts))]


def _reference_lp(model, weights, ap, batch, dev, tf32=False):
    """The reference's (n, T, C) log posteriors of a batch, time-delay
    trimmed as the system's are."""
    delay = model["timedelay"]
    lp = ref_nets.log_posteriors(model["network"], weights,
                                 batch.x_host.to(dev), ap, tf32=tf32)
    lp = lp[:, delay:].clone()
    for u, n in enumerate(batch.lengths):
        lp[u, max(int(n) - delay, 0):] = 0.0
    return lp


COMPARED = ("posterior_gap_start", "posterior_gap_widest", "segments_differ")


def compare(model, dec_cfg, ins: Inputs, outputs, dev) -> Dict[str, float]:
    """The system's outputs of the checked batches (``outputs``: batch
    index -> (log posteriors, segment lists)) against the plain
    reference: ``posterior_gap_start``, the mean |difference| of a log
    posterior from the reference's at the stated precision over the
    first ``START_FRAMES`` frames of every utterance (every pdf);
    ``posterior_gap_widest``, the largest |difference| over every frame
    of every utterance, the trimmed tail's included (the scan's state
    carried to the last frame, the trim); ``segments_differ``, the
    utterances whose segments differ from the reference decoder's on the
    system's own posteriors."""
    ref_dec = ReferenceDecoder(ins.image, pip=dec_cfg["pip"],
                               lmw=dec_cfg["lmw"], device=dev)
    total, count, widest, differ = 0.0, 0, 0.0, 0
    for i, (lp, segs) in outputs.items():
        batch = ins.batches[i]
        ref = _reference_lp(model, ins.weights, ins.log_priors, batch, dev)
        for u, n in enumerate(batch.lengths):
            gap = (lp[u, :n] - ref[u, :n]).abs()
            widest = max(widest, float(gap.max()))
            total += float(gap[:START_FRAMES].double().sum())
            count += gap[:START_FRAMES].numel()
        del ref
        for got, want in zip(segs, ref_dec.decode(lp, batch.lengths)):
            differ += got != want
    return {"posterior_gap_start": total / count,
            "posterior_gap_widest": widest,
            "segments_differ": float(differ)}


def control(cell, seed: int, dev, fault: str = "tf32") -> Dict[str, float]:
    """The control in the system's place: the reference with its float32
    products in TF32, decoded by the reference decoder, on the batches a
    run with this seed checks; judged as a run is."""
    if fault != "tf32":
        raise ValueError(f"serving cells have no {fault!r} reading")
    ins = make_inputs(cell, seed, dev)
    dec_cfg = cell.config["decoder"]
    ref_dec = ReferenceDecoder(ins.image, pip=dec_cfg["pip"],
                               lmw=dec_cfg["lmw"], device=dev)
    outputs = {}
    for i in sorted(ins.checked):
        lp = _reference_lp(cell.model, ins.weights, ins.log_priors,
                           ins.batches[i], dev, tf32=True)
        outputs[i] = (lp, ref_dec.decode(lp, ins.batches[i].lengths))
    return compare(cell.model, dec_cfg, ins, outputs, dev)
