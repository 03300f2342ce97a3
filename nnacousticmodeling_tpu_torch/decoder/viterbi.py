"""Batched triphone Viterbi decoding on the card.

Counterpart of ``nnacousticmodeling_tpu/decoder/viterbi.py``: a twin of
the native recognizer's token passing (phone_recog.cpp:138-254) with the
JAX decoder's three backends:

* ``collapsed``: the right-context-collapsed forward of
  ``viterbi_collapsed`` (CUDA kernel for CUDA tensors, plain version for
  CPU tensors), the fastest whenever the image allows it;
* ``pallas``: the dense-cube forward of ``viterbi_cube`` (likewise), for
  cube images the collapsed kernel refuses;
* ``xla``: the scan twins' forward, one launch of the
  ``viterbi_scan_forward`` kernel for CUDA tensors (``viterbi_scan``),
  on any image; for CPU tensors its plain versions, the twins
  ``_forward_scan_cube`` (cube images) and ``_forward_scan_general``
  (any image), batched over utterances with a Python loop over frames.
  The JAX package runs the twins in XLA, outside any kernel.

Every backend's backtrace is one launch of the ``viterbi_backtrace``
kernel on the card (``viterbi_backtrace.py``; its plain version for CPU
tensors), batched over utterances. ``decode_arrays_fn`` and
``decode_fn`` return the forward plus backtrace as a callable on device
tensors that makes no synchronising call, so a caller can queue it
behind the acoustic model and fetch only the segments.

Decode-relevant quirks preserved: initial mass ``lm[start_p] - log(P)``
on each phone's start biphone (phone_recog.cpp:148), the phone
insertion penalty on every phone entry including the first (:172),
entry times recorded as ``k-1`` (:173), segment boundaries emitted as
``t+1`` (:236-244), first-max tie-breaks.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.profiling import span
from .image import HmmImage
from .viterbi_backtrace import (
    COLLAPSED_ABC,
    COLLAPSED_BAC,
    LANES,
    backtrace,
    backtrace_tables,
)
from . import viterbi_scan
from .viterbi_collapsed import NEG_INF, CollapsedViterbi, UnsupportedImage
from .viterbi_cube import CubeViterbi

TIME_PACK = 2048    # minimum packing: (a* or tri) * pack + (t_entry + 1);
                    # grows per decode as the next power of two > T+1
BACKENDS = ("auto", "collapsed", "pallas", "xla")


@dataclass
class DecodeResult:
    """Segments of one utterance: (begin_frame, end_frame, phone)."""

    segments: List[Tuple[int, int, str]]

    @property
    def phones(self) -> List[str]:
        return [p for _, _, p in self.segments]


def _first_max(x: torch.Tensor, dim: int) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(max, index of its first occurrence) along ``dim``, as
    ``jnp.max`` / ``jnp.argmax``: where a slice holds a NaN, the max is
    NaN and the index that of its first NaN."""
    mx = x.amax(dim=dim, keepdim=True)
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    iota = torch.arange(n, device=x.device).reshape(shape)
    arg = torch.where((x == mx) | torch.isnan(x), iota, n).amin(dim=dim)
    return mx.squeeze(dim), arg


class ViterbiDecoder:
    """Decodes log-posterior matrices into phone segmentations on
    ``device`` (default ``cuda``).

    ``backend``: ``"auto"`` picks, in order, the collapsed kernel, the
    dense-cube kernel, then the scan twin, degrading only when a
    kernel's constructor refuses the image (``UnsupportedImage``), as
    the JAX decoder does on a TPU. ``"collapsed"`` / ``"pallas"`` force
    their kernel and re-raise its refusal; ``"xla"`` forces the scan
    twin. The ``NNAM_VITERBI_BACKEND`` environment variable overrides
    ``"auto"``. As in the JAX package, an image that is not a dense cube
    decodes through the scan twin whatever the request. ``backend``
    names the choice, made once from the image's structure: a kernel
    that fails to build or launch raises, it never hands over to the
    twin.

    One deliberate difference: off the JAX package's TPU, its ``"auto"``
    is always the scan path; here ``"auto"`` takes the same kernel on
    the CPU as on the card, and CPU tensors run that kernel's plain
    version.
    """

    def __init__(self, image: HmmImage, pip: float = 20.0, lmw: float = 1.0,
                 backend: str = "auto", beam: Optional[float] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.image = image
        # the CLI contract passes -|PIP| to the recognizer
        # (evaluateModelForTest.py:124); Init then adds it on phone entry.
        self.pip = -abs(pip)
        self.lmw = lmw
        # beam pruning: after each frame's biphone export (+LM), scores
        # below (frame max - beam) clamp to NEG_INF, the native decoder's
        # rule. None/<=0 disables.
        self.beam = float(beam) if beam is not None and beam > 0 else None
        img = image
        if img.num_triphones * TIME_PACK >= 2 ** 31:
            raise ValueError("image too large for packed backpointers")
        self.max_frames = 2 ** 31 // img.num_triphones - 2

        dev = self.device
        as_t = lambda a, dt: torch.as_tensor(  # noqa: E731
            np.asarray(a), dtype=dt, device=dev)
        self._biphone_in = as_t(img.biphone_in, torch.int64)      # (T3,)
        self._state_idxs = as_t(img.state_idxs, torch.int64)      # (T3, 3)
        self._tp_self = as_t(img.tp_selfloop, torch.float32)      # (T3, 3)
        self._tp_trans = as_t(img.tp_transition, torch.float32)   # (T3, 3)
        self._lm = as_t(img.lm * np.float32(lmw), torch.float32)  # (B,)
        fanin = img.dense_fanin()                         # (B, F), -1 pad
        self._fanin = as_t(fanin, torch.int64)   # -1 indexes from the end
        self._fanin_valid = as_t(fanin >= 0, torch.bool)
        self._fanin_any = as_t(fanin.max(axis=1) >= 0, torch.bool)
        self._end_idxs = as_t(img.end_idxs, torch.int64)          # (P,)
        # initial biphone scores: lm[start_p] - log(P) on start biphones
        p0 = np.full(img.num_biphones, NEG_INF, dtype=np.float32)
        lmw_lm = img.lm * np.float32(lmw)
        for p in range(img.num_phones):
            p0[img.start_idxs[p]] = lmw_lm[img.start_idxs[p]] - np.log(
                np.float32(img.num_phones))
        self._p0 = as_t(p0, torch.float32)

        self._cube_order = self._detect_cube_order()
        if backend == "auto":
            backend = os.environ.get("NNAM_VITERBI_BACKEND", "auto")
        if backend not in BACKENDS:
            raise ValueError(f"unknown decoder backend {backend!r}; one of "
                             f"{BACKENDS}")
        self.backend = "xla"
        self._collapsed_fwd: Optional[CollapsedViterbi] = None
        self._pallas_fwd: Optional[CubeViterbi] = None
        self._collapsed_long: Dict[int, CollapsedViterbi] = {}
        if backend != "xla" and self._cube_order is not None:
            if backend in ("collapsed", "auto"):
                try:
                    self._collapsed_fwd = CollapsedViterbi(
                        image, self._cube_order, pip=self.pip, lmw=lmw,
                        beam=self.beam, device=dev)
                    self.backend = "collapsed"
                except UnsupportedImage:
                    if backend == "collapsed":
                        raise
            if self._collapsed_fwd is None and backend in ("pallas", "auto"):
                try:
                    self._pallas_fwd = CubeViterbi(
                        image, self._cube_order, pip=self.pip, lmw=lmw,
                        beam=self.beam, device=dev)
                    self.backend = "pallas"
                except UnsupportedImage:
                    if backend == "pallas":
                        raise
        # the backtrace's tables, int32 copies for its kernel included
        P = img.num_phones
        self._bt_scan = backtrace_tables(LANES, P, self._end_idxs,
                                         self._biphone_in)
        self._scan = viterbi_scan.scan_tables(img, lmw_lm, p0, self.pip,
                                              self.beam, dev)
        self._bt_cube = self._bt_collapsed = None
        if self._pallas_fwd is not None:
            self._bt_cube = backtrace_tables(
                LANES, P, self._pallas_fwd.end_lane,
                self._pallas_fwd.bi_in_lane)
        if self._collapsed_fwd is not None:
            self._bt_collapsed = backtrace_tables(
                COLLAPSED_BAC if self._cube_order == "bac" else
                COLLAPSED_ABC, P, self._end_idxs, self._collapsed_fwd.bi2lane)

    # ------------------------------------------------------------------
    @staticmethod
    def _grow_pack(t: int) -> int:
        """Smallest power-of-two pack > t+1 (>= TIME_PACK), the one
        packing-growth rule shared by every backend."""
        pack = TIME_PACK
        while pack <= t + 1:
            pack *= 2
        return pack

    def _collapsed_pack_for(self, t: int) -> int:
        """Pack factor for a T-frame collapsed decode. The collapsed
        rows pack only the LEFT CONTEXT, so the ceiling is P * pack."""
        pack = self._grow_pack(t)
        if self.image.num_phones * pack >= 2 ** 31:
            raise ValueError(
                f"utterance of {t} frames exceeds the collapsed "
                f"packed-backpointer ceiling; split the utterance")
        return pack

    def _time_pack_for(self, t: int) -> int:
        """Pack factor for a T-frame cube or scan decode: whole triphone
        ids are packed, so the ceiling is num_triphones * pack."""
        pack = self._grow_pack(t)
        if self.image.num_triphones * pack >= 2 ** 31:
            raise ValueError(
                f"utterance of {t} frames exceeds the packed-backpointer "
                f"ceiling ({self.max_frames} frames for this image); "
                f"split the utterance")
        return pack

    def _validate_frames(self, t: int) -> None:
        """Frame-count ceiling for the backend that will decode."""
        if self._collapsed_fwd is not None:
            self._collapsed_pack_for(t)
        else:
            self._time_pack_for(t)

    def _collapsed_for_t(self, t: int) -> CollapsedViterbi:
        """Collapsed instance whose pack factor covers ``t`` frames (the
        default instance handles t < its own pack - 1; longer
        utterances get a per-pack cached instance)."""
        if t < self._collapsed_fwd.pack - 1:
            return self._collapsed_fwd
        pack = self._collapsed_pack_for(t)
        if pack not in self._collapsed_long:
            with span("nnam.decode.tables"):
                self._collapsed_long[pack] = CollapsedViterbi(
                    self.image, self._cube_order, pip=self.pip,
                    lmw=self.lmw, beam=self.beam, pack=pack,
                    device=self.device)
        return self._collapsed_long[pack]

    def _detect_cube_order(self) -> Optional[str]:
        """Detect a dense full-context triphone cube and its index
        order: 'bac' (graph builder: idx = b*P^2 + a*P + c) or 'abc'
        (synthetic builder: idx = a*P^2 + b*P + c), with biphone
        (x, y) = x*P + y."""
        img = self.image
        P = img.num_phones
        if img.num_triphones != P ** 3 or img.num_biphones != P * P:
            return None
        a, b, c = np.meshgrid(np.arange(P), np.arange(P), np.arange(P),
                              indexing="ij")
        for order, (left, center, right) in (("abc", (a, b, c)),
                                             ("bac", (b, a, c))):
            bi_in = (left * P + center).reshape(-1)
            bi_out = (center * P + right).reshape(-1)
            if (np.array_equal(img.biphone_in, bi_in)
                    and np.array_equal(img.biphone_out, bi_out)):
                return order
        return None

    # ---- the scan twins ---------------------------------------------
    def _cube_obs(self, lp_k: torch.Tensor) -> torch.Tensor:
        """(U, S) posteriors of one frame -> (U, P, P, P, 3) observation
        cube in the image's triphone order. The JAX package expands a
        tied-pdf table with a one-hot einsum at HIGHEST precision, which
        is bit-equal to this gather."""
        P = self.image.num_phones
        return lp_k[:, self._state_idxs].reshape(-1, P, P, P, 3)

    def _forward_scan_cube(self, lp: torch.Tensor, order: str
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cube twin: (U, T, S) -> packed (U, T, B) int32 ``tri * pack +
        t_entry + 1`` in original biphone order, end scores (U, T, P).

        Cube axes are [i0, i1, i2] where (left, center) come from the
        order: 'abc' -> (i0, i1), a-axis = i0; 'bac' -> (i1, i0), a-axis
        = i1. The export biphone is always (center, right); the first
        max over the left-context axis is the CSR order because triphone
        ids ascend with the left context within each (center, right).
        It gives the general twin's bits; it exists because broadcasting
        over the cube beats the general twin's index gathers (1.23x on a
        48-phone cube on an H100, PERF.md).
        """
        U, T, _ = lp.shape
        P = self.image.num_phones
        pack = self._time_pack_for(T)
        dev = lp.device
        a_axis = 1 if order == "abc" else 2        # batch axis 0
        cube = (U, P, P, P)
        tp_self = self._tp_self.reshape(P, P, P, 3)
        tp_trans = self._tp_trans.reshape(P, P, P, 3)
        lm = self._lm.reshape(P, P)                # [center, right]
        pip = torch.full((), self.pip, dtype=torch.float32, device=dev)
        iota = torch.arange(P, device=dev)
        if order == "abc":
            tri_rest = (iota[:, None] * P + iota[None, :]).to(torch.int32)
        else:
            tri_rest = (iota[:, None] * (P * P) + iota[None, :]
                        ).to(torch.int32)
        a_scale = P * P if order == "abc" else P

        p_mat = self._p0.reshape(P, P).expand(U, P, P)   # [first, second]
        pp = [torch.full(cube, NEG_INF, dtype=torch.float32, device=dev)
              for _ in range(3)]
        tt = [torch.zeros(cube, dtype=torch.int32, device=dev)
              for _ in range(3)]
        packed = torch.empty((U, T, P * P), dtype=torch.int32, device=dev)
        end = torch.empty((U, T, P), dtype=torch.float32, device=dev)
        for k in range(T):
            # p_mat is [left, center]; broadcast over the right context
            p_in = (p_mat if order == "abc" else p_mat.transpose(1, 2)
                    )[..., None] + pip
            obs = self._cube_obs(lp[:, k])
            go = (p_in.expand(cube), pp[0] + tp_trans[..., 0],
                  pp[1] + tp_trans[..., 1])
            t_go = (torch.full(cube, k - 1, dtype=torch.int32, device=dev),
                    tt[0], tt[1])
            new_pp, new_tt = [], []
            for s in range(3):
                stay = pp[s] + tp_self[..., s]
                take = go[s] > stay
                new_pp.append(torch.where(take, go[s], stay) + obs[..., s])
                new_tt.append(torch.where(take, t_go[s], tt[s]))
            pp, tt = new_pp, new_tt

            out_score = pp[2] + tp_trans[..., 2]
            mx, arg_a = _first_max(out_score, a_axis)       # (U, P, P)
            best_t = tt[2].gather(a_axis, arg_a.unsqueeze(a_axis)
                                  ).squeeze(a_axis)
            tri = arg_a.to(torch.int32) * a_scale + tri_rest
            p_new = mx + lm                                 # [b, c]
            if self.beam is not None:
                rowmax = p_new.amax(dim=(1, 2), keepdim=True)
                p_new = torch.where(p_new >= rowmax - self.beam, p_new,
                                    torch.full((), NEG_INF, device=dev))
            packed[:, k] = (tri * pack + (best_t + 1)).reshape(U, -1)
            end[:, k] = p_new.reshape(U, -1)[:, self._end_idxs]
            p_mat = p_new
        return packed, end

    def _forward_scan(self, lp: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The scan twins' forward: (U, T, S) -> packed (U, T, B) int32
        ``tri * pack + t_entry + 1`` and end scores (U, T, P), every frame
        of every utterance (rows past an utterance's length are never
        read). CPU tensors take the plain twins, any other device the
        ``viterbi_scan_forward`` kernel (which raises off CUDA)."""
        if lp.device.type == "cpu":
            return self._forward_scan_plain(lp)
        return viterbi_scan.viterbi_scan_forward(
            self._scan, lp, self._time_pack_for(lp.shape[1]))

    def _forward_scan_plain(self, lp: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The kernel's plain versions: the cube twin on a dense cube,
        else the general twin."""
        if self._cube_order is not None:
            return self._forward_scan_cube(lp, self._cube_order)
        return self._forward_scan_general(lp)

    def _forward_scan_general(self, lp: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """General twin, any image: ``_forward_scan``'s contract, the
        export a first max over each biphone's ``dense_fanin`` row."""
        U, T, _ = lp.shape
        dev = lp.device
        t3 = self.image.num_triphones
        pack = self._time_pack_for(T)
        pip = torch.full((), self.pip, dtype=torch.float32, device=dev)
        neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
        rows = torch.arange(U, device=dev)[:, None]

        p = self._p0.expand(U, -1)
        pp = [torch.full((U, t3), NEG_INF, dtype=torch.float32, device=dev)
              for _ in range(3)]
        tt = [torch.zeros((U, t3), dtype=torch.int32, device=dev)
              for _ in range(3)]
        packed = torch.empty((U, T, self.image.num_biphones),
                             dtype=torch.int32, device=dev)
        end = torch.empty((U, T, self.image.num_phones), dtype=torch.float32,
                          device=dev)
        for k in range(T):
            p_in = p[:, self._biphone_in] + pip                    # (U, T3)
            obs = lp[:, k][:, self._state_idxs]                    # (U, T3, 3)
            go = (p_in, pp[0] + self._tp_trans[:, 0],
                  pp[1] + self._tp_trans[:, 1])
            t_go = (torch.full((U, t3), k - 1, dtype=torch.int32,
                               device=dev), tt[0], tt[1])
            new_pp, new_tt = [], []
            for s in range(3):
                stay = pp[s] + self._tp_self[:, s]
                take = go[s] > stay                     # strict >, C++ :181
                new_pp.append(torch.where(take, go[s], stay) + obs[..., s])
                new_tt.append(torch.where(take, t_go[s], tt[s]))
            pp, tt = new_pp, new_tt

            # export: max over each out-biphone's feeding triphones
            out_score = pp[2] + self._tp_trans[:, 2]                # (U, T3)
            gathered = torch.where(self._fanin_valid,
                                   out_score[:, self._fanin], neg)  # (U, B, F)
            mx, col = _first_max(gathered, 2)      # first max = CSR order
            # a padding column wins where every valid slot scores below
            # NEG_INF: its id -1 exports, with the last triphone's entry
            # time (JAX indexes -1 from the end); an empty row exports 0
            best_i = torch.where(
                self._fanin_any,
                self._fanin.expand(U, -1, -1).gather(2, col[..., None])[..., 0],
                0)                                 # C++ default mxi = 0
            p_new = mx + self._lm
            if self.beam is not None:
                rowmax = p_new.amax(dim=1, keepdim=True)
                p_new = torch.where(p_new >= rowmax - self.beam, p_new, neg)
            best_t = tt[2][rows, best_i]
            packed[:, k] = best_i.to(torch.int32) * pack + (best_t + 1)
            end[:, k] = p_new[:, self._end_idxs]
            p = p_new
        return packed, end

    # ---- backtraces ---------------------------------------------------
    def _device_backtrace(self, packed, end_scores, lengths, tables=None,
                          early_exit=True):
        """Backtrace over ``tri * pack + t_entry + 1`` rows, by default
        in the scan twins' original biphone indexing; the cube kernel's
        tables map its right-major lanes."""
        return backtrace(self._bt_scan if tables is None else tables,
                         packed, end_scores, lengths,
                         self._time_pack_for(packed.shape[1]), early_exit)

    def _pallas_backtrace(self, packed, end_scores, lengths,
                          early_exit=True):
        """Backtrace over the cube kernel's right-major packed rows."""
        return self._device_backtrace(packed, end_scores, lengths,
                                      self._bt_cube, early_exit)

    def _collapsed_backtrace(self, packed, end_scores, lengths,
                             early_exit=True):
        """Backtrace over the collapsed per-lane ``a* * pack + t_entry +
        1`` rows, at the pack factor of the instance that PRODUCED them."""
        pack = self._collapsed_for_t(packed.shape[1]).pack
        return backtrace(self._bt_collapsed, packed, end_scores, lengths,
                         pack, early_exit)

    # ------------------------------------------------------------------
    def _to_results(self, segs: np.ndarray, counts: np.ndarray
                    ) -> List[DecodeResult]:
        names = self.image.phone_names
        out = []
        for u in range(segs.shape[0]):
            k = int(counts[u])
            rows = segs[u, :k][::-1]                      # stored last-first
            out.append(DecodeResult(segments=[
                (int(b), int(e), names[int(tri)]) for b, e, tri in rows]))
        return out

    def _decode_arrays(self, lp: torch.Tensor, lengths: torch.Tensor,
                       early_exit: bool = True):
        """Forward + backtrace on the device -> (segs, counts) tensors,
        the one route of ``decode_batch``, ``decode_one`` and
        ``decode_arrays_fn``. The collapsed kernel covers any length
        through per-pack instances; the cube kernel packs whole
        triphone ids at the fixed minimum factor, so longer utterances
        take the scan twin, as in the JAX package (``viterbi.py:574-588``,
        ``:590-603``)."""
        if self._collapsed_fwd is not None:
            forward = self._collapsed_for_t(lp.shape[1]).forward
            back = self._collapsed_backtrace
        elif self._pallas_fwd is not None and lp.shape[1] < TIME_PACK - 1:
            forward, back = self._pallas_fwd.forward, self._pallas_backtrace
        else:
            return self._decode_scan(lp, lengths, early_exit)
        with span("nnam.decode.forward"):
            packed, end_scores = forward(lp, lengths)
        with span("nnam.decode.backtrace"):
            return back(packed, end_scores, lengths, early_exit)

    def _decode_scan(self, lp: torch.Tensor, lengths: torch.Tensor,
                     early_exit: bool = True):
        """The scan twin and its backtrace (the JAX ``vmap(
        _decode_device)``)."""
        with span("nnam.decode.forward"):
            packed, end_scores = self._forward_scan(lp)
        with span("nnam.decode.backtrace"):
            return self._device_backtrace(packed, end_scores, lengths,
                                          early_exit=early_exit)

    def _as_input(self, log_probs, lengths):
        lp = torch.as_tensor(log_probs, dtype=torch.float32,
                             device=self.device).contiguous()
        lens = torch.as_tensor(lengths, dtype=torch.int32,
                               device=self.device)
        return lp, lens

    def _device_input(self, lp: torch.Tensor, lengths, check_frames):
        """``lp`` and ``lengths`` checked for the device callables: ``lp``
        a (U, T, S) floating tensor on the decoder's device (no move)
        whose T passes ``check_frames``, ``lengths`` U lengths as int32
        on it."""
        dev = self._p0.device          # the tables' device, index resolved
        if not isinstance(lp, torch.Tensor) or lp.device != dev:
            where = lp.device if isinstance(lp, torch.Tensor) else type(lp)
            raise ValueError(f"lp on {where}; this decoder decodes on "
                             f"{dev}: move it there first")
        if (lp.dim() != 3 or lp.shape[2] != self.image.num_states
                or not lp.is_floating_point()):
            raise ValueError(f"lp must be a floating (U, T, "
                             f"{self.image.num_states}) tensor, got "
                             f"{lp.dtype} {tuple(lp.shape)}")
        U, T = lp.shape[:2]
        check_frames(T)
        if isinstance(lengths, torch.Tensor):
            if lengths.device != dev:
                raise ValueError(f"lengths on {lengths.device}; this "
                                 f"decoder decodes on {dev}")
            if lengths.shape != (U,) or lengths.is_floating_point():
                raise ValueError(f"lengths must be {U} integers, got "
                                 f"{lengths.dtype} {tuple(lengths.shape)}")
            lens = lengths.to(torch.int32)
        else:
            host = np.asarray(lengths)
            if host.shape != (U,) or not np.issubdtype(host.dtype,
                                                       np.integer):
                raise ValueError(f"lengths must be {U} integers, got "
                                 f"{host.dtype} {host.shape}")
            if host.size and (host.min() < 0 or host.max() > T):
                raise ValueError(f"lengths must lie in [0, {T}]")
            lens = torch.from_numpy(host.astype(np.int32)).to(dev)
        return lp.to(torch.float32).contiguous(), lens

    def decode_arrays_fn(self):
        """``(lp, lengths) -> (segs, counts)`` on the device with the
        decoder's backend: the collapsed kernel at any T, the cube
        kernel below ``TIME_PACK - 1`` frames, else the scan twin (JAX
        ``viterbi.py:590-603``).

        ``lp`` is a (U, T, S) float32 tensor on the decoder's device
        (another device raises ``ValueError``; nothing is moved).
        ``lengths`` holds U lengths in [0, T]: a tensor on the same
        device, or a host sequence, which the call copies to the device
        once (that copy is the caller's, and waits for the host).
        ``segs`` is (U, T, 3) int32 [begin, end, triphone] from the
        LAST segment at index 0, ``counts`` (U,) the segments of each
        utterance; frames past a length are computed and ignored.

        With device lengths the call makes no synchronising call and no
        host copy (the backtrace is one kernel launch; on the CPU its
        plain version runs all T hops with no host check), so a caller
        can queue several batches behind the acoustic model and read
        only the results it needs. The first call at a T that
        needs a larger pack factor builds (and caches) that factor's
        collapsed tables, a one-time copy."""
        def fn(lp: torch.Tensor, lengths):
            lp, lens = self._device_input(lp, lengths, self._validate_frames)
            return self._decode_arrays(lp, lens, early_exit=False)
        return fn

    def decode_fn(self):
        """``(lp, lengths) -> (segs, counts)`` through the scan twin and
        its device backtrace, whatever the backend (JAX
        ``viterbi.py:622-625``, ``vmap(_decode_device)``). Arguments,
        results and the no-synchronisation contract are
        ``decode_arrays_fn``'s."""
        def fn(lp: torch.Tensor, lengths):
            lp, lens = self._device_input(lp, lengths, self._time_pack_for)
            return self._decode_scan(lp, lens, early_exit=False)
        return fn

    def decode_one(self, log_probs) -> DecodeResult:
        """Decode one utterance's (T, S) log-posterior matrix."""
        if log_probs.shape[1] != self.image.num_states:
            raise ValueError(
                f"posterior columns {log_probs.shape[1]} != image states "
                f"{self.image.num_states}")
        self._validate_frames(log_probs.shape[0])
        lp, lens = self._as_input(log_probs[None], [log_probs.shape[0]])
        segs, count = self._decode_arrays(lp, lens)
        return self._to_results(segs.cpu().numpy(), count.cpu().numpy())[0]

    def decode_batch(self, log_probs, lengths: Sequence[int]
                     ) -> List[DecodeResult]:
        """Decode a padded batch (U, T_max, S) with per-utterance lengths.
        Accepts numpy arrays or tensors; frames past each utterance's
        length are ignored."""
        if log_probs.shape[2] != self.image.num_states:
            raise ValueError("posterior/state mismatch")
        self._validate_frames(log_probs.shape[1])
        lp, lens = self._as_input(log_probs, lengths)
        segs, counts = self._decode_arrays(lp, lens)
        return self._to_results(segs.cpu().numpy(), counts.cpu().numpy())
