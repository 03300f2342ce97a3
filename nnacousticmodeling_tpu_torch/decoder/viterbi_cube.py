"""Dense-cube Viterbi forward: CUDA kernel wrapper, its plain PyTorch
version, and the host precompute they share.

Counterpart of ``nnacousticmodeling_tpu/decoder/viterbi_pallas.py``
(``PallasCubeViterbi``). The DP planes are (3 states, PS left-context
rows, B = P^2 lanes) with the lane axis in RIGHT-MAJOR biphone order:
triphone (a, b, c) sits at [row a, lane c*P + b], which is its
out-biphone (b, c), so the per-biphone export is a first max over rows
and the exported row is the next frame's biphone score row in place.
The host precompute keeps the TPU kernel's semantic refusals and its
layout; what changes is how a frame reads its inputs:

* no per-frame table of distinct-pdf scores and no class-selection
  planes: one int32 plane ``pdf[s, a, c*P + b]`` names the pdf whose
  log-posterior each cell adds (pad rows a >= P take the first distinct
  pdf of their (center, state), as the TPU kernel's class 0), gathered
  straight from ``lp``;
* the one-hot entry matmul ``(Ea * p) @ Fb`` becomes the exact gather
  ``q[a, b] = p[b*P + a]`` (0.0 on pad rows, where the product has no
  nonzero term);
* the irregular-end matmul ``p @ E_end`` and the static end slice both
  become one gather through ``end_lane = lane_map[end_idxs]``.

Each of the TPU kernel's matmuls had exactly one nonzero term per
output, so these gathers give the same bits. No matmul and no TF32 is
left on this path. The TPU's lane-tiling refusal (``B % 128``) is
dropped: it was a limit of the TPU's sublane gathers.

Outputs are those of ``PallasCubeViterbi.forward``: packed backpointers
(U, T, B) int32 on the right-major lane axis, ``tri * 2048 + t_entry +
1``, and end scores (U, T, P) float32 in original phone order,
bit-identical to the XLA scan path for every frame t < lengths[u].

As the collapsed kernel, the kernel has a cluster route and a
device-memory route, picked by ``viterbi_cluster_plan``; a lane count
that no cluster splits into slices of a multiple of 8 lanes (an odd P)
takes the device-memory route. Its cluster route keeps the state in
shared memory: the collapsed kernel's register route, built for this
kernel, spilled at the card's 96 registers a thread and ran slower
(``csrc/viterbi_cube.cu``). ``kernels.launches`` counts the routes
apart, as ``cube_viterbi_forward`` and ``cube_viterbi_forward.global``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..utils.device import resolve_device
from .viterbi_collapsed import (
    NEG_INF,
    UnsupportedImage,
    ViterbiPlan,
    _ceil,
    _check_lp,
    _route,
    cluster_capacity,
    cluster_records,
    longest_first,
    viterbi_cluster_plan,
)

#: the cube kernel's fixed pack factor: it decodes T < TIME_PACK - 1
TIME_PACK = 2048


class CubeViterbi:
    """Forward token passing for dense full-context cube images.

    ``cube_order`` is 'bac' (the TIMIT graph's, idx = b*P^2 + a*P + c) or
    'abc' (``make_synthetic_image``'s, idx = a*P^2 + b*P + c), as
    ``ViterbiDecoder._detect_cube_order`` finds it. ``forward(lp,
    lengths)`` maps a padded posterior batch (U, T, S) on ``device`` to
    packed backpointers (U, T, B) int32 (right-major lanes: index via
    ``end_lane`` / ``bi_in_lane``, convert whole rows with ``lane_map``)
    and end scores (U, T, P) float32 in original phone order. Rows t >=
    lengths[u] are unspecified.
    """

    def __init__(self, image, cube_order: str, pip: float, lmw: float,
                 beam=None, device="cuda"):
        P = image.num_phones
        B = image.num_biphones
        if image.num_triphones != P ** 3 or B != P * P:
            raise UnsupportedImage("not a dense cube image")
        if image.num_triphones * TIME_PACK >= 2 ** 31:
            raise UnsupportedImage("triphone count too large to pack")
        self.P, self.B, self.S = P, B, image.num_states
        self.PS = _ceil(P, 8)
        PS = self.PS
        self.cube_order = cube_order
        self.device = resolve_device(device)

        # --- cube views in (left, center, right) order ----------------
        def to_lcr(arr3):
            cube = arr3.reshape((P, P, P) + arr3.shape[1:])
            if cube_order == "bac":               # (center, left, right)
                cube = cube.transpose((1, 0, 2) + tuple(
                    range(3, cube.ndim)))
            return cube

        pdf = to_lcr(image.state_idxs)            # (a, b, c, 3)
        tps_c = to_lcr(image.tp_selfloop)
        tpt_c = to_lcr(image.tp_transition)

        # --- pdf plane and transition planes: [s, a, c*P + b] ----------
        # (lanes {c*P + b} of center b: start b, stride P); transitions
        # must be a function of (center, state, pdf class)
        pdf_plane = np.zeros((3, PS, B), np.int32)
        tps = np.full((6, PS, B), NEG_INF, dtype=np.float32)
        for b in range(P):
            for s in range(3):
                plane = pdf[:, b, :, s]           # (left, right)
                distinct, inverse = np.unique(plane, return_inverse=True)
                inverse = inverse.reshape(P, P)
                pdf_plane[s, :P, b::P] = plane
                pdf_plane[s, P:, b::P] = distinct[0]
                counts = np.bincount(inverse.reshape(-1),
                                     minlength=len(distinct))
                for which, cube_tp in ((0, tps_c), (1, tpt_c)):
                    tp_plane = cube_tp[:, b, :, s]
                    sums = np.zeros(len(distinct), np.float64)
                    np.add.at(sums, inverse.reshape(-1),
                              tp_plane.reshape(-1))
                    means = (sums / counts).astype(np.float32)
                    if not np.all(tp_plane == means[inverse]):
                        raise UnsupportedImage(
                            "transition probs not tied to pdf classes")
                    tps[which * 3 + s, :P, b::P] = means[inverse]

        # --- lane maps (original biphone id x*P + y -> lane y*P + x) ----
        lane = np.arange(B)
        lane_map = (lane % P) * P + lane // P
        self.lane_map = lane_map
        end_lane = lane_map[np.asarray(image.end_idxs)]

        # --- rows: LM, initial biphone scores, triphone id bases --------
        lm = image.lm.astype(np.float32) * np.float32(lmw)
        p0 = np.full(B, NEG_INF, dtype=np.float32)
        p0[image.start_idxs] = (lm[image.start_idxs]
                                - np.log(np.float32(P)))
        lm_p = np.empty(B, np.float32)
        p0_p = np.empty(B, np.float32)
        lm_p[lane_map] = lm
        p0_p[lane_map] = p0
        b_of, c_of = lane % P, lane // P
        if cube_order == "abc":                   # tri = a*P^2 + b*P + c
            self.a_coef = P * P
            tri_base = b_of * P + c_of
        else:                                     # tri = b*P^2 + a*P + c
            self.a_coef = P
            tri_base = b_of * (P * P) + c_of

        self._pip = float(pip)
        # beam pruning (ViterbiDecoder.beam rule): clamp exported biphone
        # scores below (frame max - beam) to NEG_INF
        self._beam = float(beam) if beam is not None and beam > 0 else None

        dev = self.device
        as_t = lambda a, dt: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a)).to(dtype=dt, device=dev)
        self.pdf = as_t(pdf_plane, torch.int32)       # (3, PS, B)
        self.tps = as_t(tps, torch.float32)           # (6, PS, B)
        self.lm = as_t(lm_p, torch.float32)           # (B,)
        self.p0 = as_t(p0_p, torch.float32)           # (B,)
        self.tri_base = as_t(tri_base, torch.int32)   # (B,)
        # original-id maps for the backtrace (viterbi.py)
        self.end_lane = as_t(end_lane, torch.int64)   # (P,)
        self.bi_in_lane = as_t(lane_map[np.asarray(image.biphone_in)],
                               torch.int64)           # (T3,)
        # q[a, b] = p[b*P + a]: the entry gather's source lanes
        self.qsrc = as_t(np.arange(P)[None, :] * P + np.arange(P)[:, None],
                         torch.int64)                 # (P, P) [a, b]
        self.plan = viterbi_cluster_plan(PS, B, self.S, registers=False)
        if self.plan.route == "cluster":
            self.records = as_t(cluster_records(pdf_plane, tps),
                                torch.int32)          # (8 PS B,)

    def forward(self, lp: torch.Tensor, lengths=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(U, T, S) float32 log-posteriors -> (packed (U, T, B) int32,
        end (U, T, P) float32). CUDA tensors launch the kernel (or
        raise); CPU tensors take the plain version."""
        if lengths is None:
            lengths = torch.full((lp.shape[0],), lp.shape[1],
                                 dtype=torch.int32)
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=lp.device)
        if lp.device.type == "cpu":
            return cube_viterbi_reference(self, lp, lengths)
        return cube_viterbi_forward(self, lp, lengths)


def cube_viterbi_reference(cv: CubeViterbi, lp: torch.Tensor,
                           lengths: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: every frame of every
    utterance, batched over utterances, in the TPU kernel's float32
    operation order: ``p_in = q + pip``; strict ``>`` go/stay selects,
    ``+ obs`` after the select; ``out = pp2 + tps[5]`` and a first max
    over rows; ``pnew = mx + lm``; then the beam clamp ``pnew >= rowmax
    - beam``."""
    U, T, S = lp.shape
    PS, B, P = cv.PS, cv.B, cv.P
    dev = lp.device
    lp = lp.float()
    tps = cv.tps
    pdf = cv.pdf.long().reshape(-1)
    pip = torch.full((), cv._pip, dtype=torch.float32, device=dev)
    rows = torch.arange(PS, device=dev)[:, None]                 # (PS, 1)
    pad = torch.zeros((U, PS - P, P), dtype=torch.float32, device=dev)

    pp = torch.full((U, 3, PS, B), NEG_INF, dtype=torch.float32, device=dev)
    tt = torch.zeros((U, 3, PS, B), dtype=torch.int32, device=dev)
    pc = cv.p0.expand(U, B).clone()
    packed = torch.empty((U, T, B), dtype=torch.int32, device=dev)
    end = torch.empty((U, T, P), dtype=torch.float32, device=dev)
    for k in range(T):
        # entry: exact gather in place of the one-hot matmul, tiled over
        # the right contexts (lane c*P + b takes q[:, b])
        q = torch.cat([pc[:, cv.qsrc], pad], dim=1)              # (U, PS, P)
        p_in = (q + pip).repeat(1, 1, P)                         # (U, PS, B)
        obs = lp[:, k, pdf].reshape(U, 3, PS, B)
        old0, old1, old2 = pp[:, 0], pp[:, 1], pp[:, 2]
        t0o, t1o, t2o = tt[:, 0], tt[:, 1], tt[:, 2]

        go2 = old1 + tps[4]
        stay2 = old2 + tps[2]
        take2 = go2 > stay2
        pp2 = torch.where(take2, go2, stay2) + obs[:, 2]
        tt2 = torch.where(take2, t1o, t2o)

        go1 = old0 + tps[3]
        stay1 = old1 + tps[1]
        take1 = go1 > stay1
        pp1 = torch.where(take1, go1, stay1) + obs[:, 1]
        tt1 = torch.where(take1, t0o, t1o)

        stay0 = old0 + tps[0]
        take0 = p_in > stay0
        pp0 = torch.where(take0, p_in, stay0) + obs[:, 0]
        tt0 = torch.where(take0, torch.full_like(t0o, k - 1), t0o)

        pp = torch.stack([pp0, pp1, pp2], dim=1)
        tt = torch.stack([tt0, tt1, tt2], dim=1)

        # export: first max over left-context rows; a column whose max
        # is NaN matches no row and takes the TPU kernel's arg = P and
        # bt = the sum of tt2 over rows equal to P (pad row P, or none)
        out_score = pp2 + tps[5]                                 # (U, PS, B)
        mx = out_score.amax(dim=1, keepdim=True)
        arg = torch.where(out_score == mx, rows, P).amin(dim=1)  # (U, B)
        bt = torch.where(arg < PS, tt2.gather(
            1, arg.clamp(max=PS - 1)[:, None, :])[:, 0], 0)
        tri = arg.to(torch.int32) * cv.a_coef + cv.tri_base
        packed[:, k] = tri * TIME_PACK + bt + 1
        pnew = mx[:, 0] + cv.lm                                  # (U, B)
        if cv._beam is not None:
            rowmax = pnew.amax(dim=1, keepdim=True)
            pnew = torch.where(pnew >= rowmax - cv._beam, pnew,
                               torch.full((), NEG_INF, device=dev))
        end[:, k] = pnew[:, cv.end_lane]
        pc = pnew
    return packed, end


_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p])
_CLUSTER_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                     + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p])
_CAPACITY_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]


def _lib():
    lib = kernels.load("viterbi_cube")
    lib.cube_viterbi_forward.argtypes = _ARGTYPES
    lib.cube_viterbi_forward.restype = ctypes.c_int
    lib.cube_viterbi_cluster.argtypes = _CLUSTER_ARGTYPES
    lib.cube_viterbi_cluster.restype = ctypes.c_int
    lib.cube_viterbi_cluster_capacity.argtypes = _CAPACITY_ARGTYPES
    lib.cube_viterbi_cluster_capacity.restype = ctypes.c_int
    return lib


def cube_cluster_capacity(cv: CubeViterbi) -> int:
    """Clusters of ``cv``'s plan the card holds at once."""
    return cluster_capacity(_lib().cube_viterbi_cluster_capacity, cv.PS,
                            cv.B, cv.S, cv.plan.cluster)


def cube_viterbi_forward(cv: CubeViterbi, lp: torch.Tensor,
                         lengths: torch.Tensor, route: Optional[str] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CUDA kernel wrapper (``csrc/viterbi_cube.cu``) on ``cv.plan``'s
    route: one cluster (or, on the device-memory route, one block) per
    utterance walks its frames up to its length. Rows past an
    utterance's length are left unwritten. ``route="global"`` forces the
    device-memory route (tests and chip_smoke.py)."""
    name = "cube_viterbi_forward"
    plan = _route(name, cv.plan, route)
    _check_lp(name, cv.tps, cv.S, lp, lengths)
    if lp.shape[1] >= TIME_PACK - 1:
        raise ValueError(f"{name}: {lp.shape[1]} frames; the cube kernel "
                         f"packs T < {TIME_PACK - 1}")
    stream = torch.cuda.current_stream(lp.device).cuda_stream
    return _cube_launch(cv, lp, lengths, plan, _lib(), stream)


def _cube_launch(cv: CubeViterbi, lp: torch.Tensor, lengths: torch.Tensor,
                 plan: ViterbiPlan, lib, stream
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The outputs (and, on the device-memory route, the scratch) of one
    launch of ``plan``'s route through ``lib``'s entry points."""
    U, T, S = lp.shape
    PS, B, P = cv.PS, cv.B, cv.P
    dev = lp.device
    end_lane = cv.end_lane.to(torch.int32)
    packed = torch.empty((U, T, B), dtype=torch.int32, device=dev)
    end = torch.empty((U, T, P), dtype=torch.float32, device=dev)
    beam = cv._beam if cv._beam is not None else 0.0
    scalars = (cv.a_coef, cv._pip, beam, int(cv._beam is not None))
    if plan.route == "cluster":
        order = longest_first(lengths)
        status = lib.cube_viterbi_cluster(
            lp.data_ptr(), lengths.data_ptr(), order.data_ptr(),
            cv.records.data_ptr(), cv.lm.data_ptr(), cv.p0.data_ptr(),
            cv.tri_base.data_ptr(), end_lane.data_ptr(),
            packed.data_ptr(), end.data_ptr(), U, T, S, P, PS, B, *scalars,
            plan.cluster, stream)
        name = "cube_viterbi_forward"
    else:
        pp = torch.empty((U, 3, PS, B), dtype=torch.float32, device=dev)
        tt = torch.empty((U, 3, PS, B), dtype=torch.int32, device=dev)
        status = lib.cube_viterbi_forward(
            lp.data_ptr(), lengths.data_ptr(), cv.pdf.data_ptr(),
            cv.tps.data_ptr(), cv.lm.data_ptr(), cv.p0.data_ptr(),
            cv.tri_base.data_ptr(), end_lane.data_ptr(), pp.data_ptr(),
            tt.data_ptr(), packed.data_ptr(), end.data_ptr(), U, T, S, P,
            PS, B, *scalars, stream)
        name = "cube_viterbi_forward.global"
    kernels.check(status, name)
    kernels.launches[name] += 1
    return packed, end
