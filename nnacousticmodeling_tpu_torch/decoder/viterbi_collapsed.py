"""Right-context-collapsed Viterbi forward: CUDA kernel wrapper, its
plain PyTorch version, and the host precompute they share.

Counterpart of ``nnacousticmodeling_tpu/decoder/viterbi_collapsed.py``
(``PallasCollapsedViterbi``). Two triphones (a, b, c) and (a, b, c')
whose pdf ids agree for every (left context a, state s) have identical
DP traces, so the right-context axis collapses into joint classes per
center phone; classes are split into pseudo-centers of at most ``cap``
and the DP planes are (3 states, PS left-context rows, L = cap * Pp
lanes) with lane = class_slot * Pp + pseudo_center. The host precompute
(``__init__``) is the JAX package's, line for line; what changes is how
a frame reads its inputs:

* no per-frame ``vals`` table of distinct-pdf scores: one int32 plane
  ``pdf[s, a, j] = table[s, sel[s, a, j], j % Pp]`` names the pdf whose
  log-posterior each cell adds, gathered straight from ``lp``. It is the
  value the TPU kernel's ``obs_plane`` selects, pad rows and lanes
  included;
* the one-hot entry matmul ``(Ea * pc) @ Fb`` becomes an exact gather
  ``q[a, bp] = pc[src[a, bp]]`` with 0.0 where the matmul has no
  nonzero term, then ``+ lmq``, the beam clamp, ``+ pip``.

Outputs are those of the TPU kernel's ``_forward_impl``: packed
backpointers (U, T, L) int32 in collapsed-lane space, ``a* * pack +
t_entry + 1``, and end scores (U, T, P) float32, bit-identical to the
XLA scan path for every frame t < lengths[u].

The kernel has two routes, and ``viterbi_cluster_plan`` (shared with
the dense-cube kernel) picks one from the image's size: the cluster
route keeps each utterance's DP state on the chip of a cluster of at
most 16 blocks (``csrc/viterbi_cluster.cuh``), in its threads' registers
where each warp owns one chunk of lanes and a kernel is built for the
rows' count of row steps (the register route), else in the blocks'
shared memory; the
device-memory route, for images whose state no such cluster holds,
keeps it in a (U, 3, PS, L) scratch. ``kernels.launches`` counts
``collapsed_viterbi_forward`` (cluster) apart from
``collapsed_viterbi_forward.global``, and the register route's calls
again as ``collapsed_viterbi_forward.registers``.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..ops.rnn_cuda import SMEM_LIMIT
from ..utils.device import resolve_device

NEG_INF = -1.0e20
TIME_PACK = 2048
#: initial beam threshold, the TPU kernel's (viterbi_collapsed.py:366)
THR0 = -3.0e38
#: classes per pseudo-center (the JAX package's default ``cap``)
CAP = 8

#: csrc/viterbi_cluster.cuh: the cluster sizes tried, in order; the lanes
#: of a warp and its row groups (a warp owns 8 lanes, each group of 8
#: threads every fourth row); the warps a block at most; the most row
#: steps a thread keeps in registers on the register route (a kernel for
#: each even count), and the most frames its 16-bit entry times hold
CLUSTER_SIZES = (1, 2, 4, 8, 16)
LANE_CHUNK = 8
ROW_GROUPS = 4
MAX_WARPS = 18
REG_STEPS = 12
REG_FRAMES = 32767


@dataclass(frozen=True)
class ViterbiPlan:
    """The route of a Viterbi forward (``"cluster"`` or ``"global"``, the
    device-memory route) and, on the cluster route, its layout: ``cluster``
    blocks an utterance, each owning ``slice`` lanes of every state and
    row, with ``threads`` threads and ``smem_bytes`` of shared memory, and
    the DP state in the threads' registers (``registers``, the register
    route) or in the blocks' shared memory."""
    route: str
    cluster: int = 0
    slice: int = 0
    threads: int = 0
    smem_bytes: int = 0
    registers: bool = False


def cluster_smem_bytes(ps: int, lanes: int, s: int, c: int,
                       registers: bool = False) -> int:
    """Shared memory of one cluster-route block (``smem_bytes`` of
    csrc/viterbi_cluster.cuh): its state slice (score and entry time a
    cell; none on the register route), two full exported rows padded by
    ``ps``, two publish slots, two row maxima and two thresholds (each
    pair padded to four words) and two posterior rows."""
    w = lanes // c
    state = 0 if registers else 3 * ps * w * 8
    return (state + 2 * (lanes + ps) * 4 + 2 * w * 4 + 16 + 16
            + 2 * _ceil(s, 4) * 4)


def registers_fit(ps: int, slice_: int) -> bool:
    """Whether a block of ``slice_`` lanes can keep its state in its
    threads' registers (``check_layout`` of csrc/viterbi_cluster.cuh): one
    chunk a warp, and the rows an even count of row steps up to
    ``REG_STEPS``, for which a kernel is built."""
    steps = ps // ROW_GROUPS
    return (steps <= REG_STEPS and steps % 2 == 0
            and slice_ // LANE_CHUNK <= MAX_WARPS)


def viterbi_cluster_plan(ps: int, lanes: int, s: int,
                         smem_limit: int = SMEM_LIMIT,
                         registers: bool = True) -> ViterbiPlan:
    """Lay out a Viterbi forward of ``ps`` rows, ``lanes`` lanes and ``s``
    pdfs: the smallest cluster in ``CLUSTER_SIZES`` whose blocks each
    hold a slice of a multiple of ``LANE_CHUNK`` lanes, its state
    included, in ``smem_limit`` bytes (fewer blocks a cluster, more
    utterances at once), with the state in registers where that slice
    allows (``registers_fit``; ``registers=False``: never); the
    device-memory route where no cluster does. Pure host arithmetic."""
    if ps % ROW_GROUPS == 0:
        for c in CLUSTER_SIZES:
            w = lanes // c
            if lanes % c or w % LANE_CHUNK:
                continue
            if cluster_smem_bytes(ps, lanes, s, c) <= smem_limit:
                regs = registers and registers_fit(ps, w)
                return ViterbiPlan("cluster", c, w,
                                   32 * min(w // LANE_CHUNK, MAX_WARPS),
                                   cluster_smem_bytes(ps, lanes, s, c, regs),
                                   regs)
    return ViterbiPlan("global")


def cell_order(x: np.ndarray) -> np.ndarray:
    """A (ps, lanes) plane in the cluster route's record order: row step
    i = a // 4, lane chunk j // 8, then the warp's thread (a % 4) * 8 + j
    % 8, so the 32 cells a warp handles at one row step are contiguous."""
    ps, lanes = x.shape
    return np.ascontiguousarray(x.reshape(
        ps // ROW_GROUPS, ROW_GROUPS, lanes // LANE_CHUNK, LANE_CHUNK
    ).transpose(0, 2, 1, 3).reshape(-1))


def cluster_records(pdf: np.ndarray, tps: np.ndarray,
                    src: Optional[np.ndarray] = None) -> np.ndarray:
    """The cluster route's cell records, each kind in ``cell_order``, as
    one (8 * cells,) int32 array: the states-1-2 records (transition
    planes 1-4, f32 bits; an int4 a cell), the export records (plane 5,
    pdf1 | pdf2 << 16; an int2) and the state-0 records (plane 0, pdf0 |
    src << 16; an int2). ``src`` is the collapsed kernel's entry source
    lane (-1 for none), 0 for the cube kernel."""
    if pdf.max() >= 1 << 16 or (src is not None and src.max() >= 1 << 15):
        raise UnsupportedImage("pdf ids or lanes too many for 16 bits")
    bits = lambda x: cell_order(  # noqa: E731
        np.ascontiguousarray(x, np.float32)).view(np.int32)
    low = lambda x: cell_order(x).astype(np.int64) & 0xFFFF  # noqa: E731
    pair = lambda lo, hi: (lo | hi << 16).astype(  # noqa: E731
        np.uint32).view(np.int32)
    hi = low(src) if src is not None else 0
    return np.concatenate([
        np.stack([bits(tps[q]) for q in (1, 2, 3, 4)], axis=1).reshape(-1),
        np.stack([bits(tps[5]), pair(low(pdf[1]), low(pdf[2]))],
                 axis=1).reshape(-1),
        np.stack([bits(tps[0]), pair(low(pdf[0]), hi)], axis=1).reshape(-1)])


def longest_first(lengths: torch.Tensor) -> torch.Tensor:
    """The utterances by descending length (ties in index order), int32 on
    ``lengths``' device: cluster i of the cluster route decodes
    utterance ``order[i]``, so the longest start first."""
    return torch.argsort(lengths, descending=True, stable=True).to(
        torch.int32)


class UnsupportedImage(ValueError):
    """The image lacks the structure a Viterbi kernel relies on (raised by
    both the collapsed and the dense-cube kernel's constructors)."""


def _ceil(x: int, m: int) -> int:
    return -(-x // m) * m


class CollapsedViterbi:
    """Collapsed-lane forward token passing for dense cube images.

    ``forward(lp, lengths)`` maps a padded posterior batch (U, T, S) on
    ``device`` to packed backpointers (U, T, L) int32 in collapsed-lane
    space (index via ``bi2lane``) and end scores (U, T, P) float32 in
    original phone order. Rows t >= lengths[u] are unspecified.
    """

    def __init__(self, image, cube_order: str, pip: float, lmw: float,
                 beam=None, pack: int = TIME_PACK, device="cuda"):
        P = image.num_phones
        B = image.num_biphones
        cap = CAP
        if image.num_triphones != P ** 3 or B != P * P:
            raise UnsupportedImage("not a dense cube image")
        self.pack = int(pack)
        if P * self.pack >= 2 ** 31:
            raise UnsupportedImage("pack factor too large")
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

        # --- transition tying check: tp must be a function of
        # (center, state, pdf id)
        for b in range(P):
            for s in range(3):
                plane = pdf[:, b, :, s]
                for cube_tp in (tps_c, tpt_c):
                    tpl = cube_tp[:, b, :, s]
                    distinct, inverse = np.unique(plane, return_inverse=True)
                    inverse = inverse.reshape(-1)
                    sums = np.zeros(len(distinct), np.float64)
                    np.add.at(sums, inverse, tpl.reshape(-1))
                    counts = np.bincount(inverse, minlength=len(distinct))
                    means = (sums / counts).astype(np.float32)
                    if not np.all(tpl.reshape(-1) == means[inverse]):
                        raise UnsupportedImage(
                            "transition probs not tied to pdf classes")

        # --- common end right-context (for the static end-lane slice) --
        end_idxs = np.asarray(image.end_idxs)
        if not (len(end_idxs) == P
                and np.all(end_idxs // P == np.arange(P))
                and len(set(end_idxs % P)) == 1):
            raise UnsupportedImage("ends not (p, r_end) per phone")
        r_end = int(end_idxs[0] % P)

        # --- joint right-context classes per center --------------------
        cls_of = np.zeros((P, P), np.int64)
        n_cls = np.zeros(P, np.int64)
        for b in range(P):
            key = pdf[:, b, :, :].transpose(1, 0, 2).reshape(P, -1)
            u, inv = np.unique(key, axis=0, return_inverse=True)
            inv = inv.reshape(-1)
            n = len(u)
            # end class first: end lane = lane 0 of the first chunk
            order = list(range(n))
            ke = int(inv[r_end])
            order.remove(ke)
            order.insert(0, ke)
            rank = np.empty(n, np.int64)
            rank[order] = np.arange(n)
            cls_of[b] = rank[inv]
            n_cls[b] = n

        # --- pseudo-centers: chunks of <= cap classes ------------------
        pseudo_real = []
        pseudo_cls0 = []
        base_of = np.zeros(P, np.int64)
        for b in range(P):
            base_of[b] = len(pseudo_real)
            for i in range(0, int(n_cls[b]), cap):
                pseudo_real.append(b)
                pseudo_cls0.append(i)
        n_pseudo = len(pseudo_real)
        gran = 128 // math.gcd(128, cap)
        Pp = _ceil(max(n_pseudo, 1), gran)
        L = cap * Pp                     # multiple of lcm(128, cap)
        self.Pp, self.L, self.cap = Pp, L, cap
        pseudo_real = np.asarray(pseudo_real + [0] * (Pp - n_pseudo))
        pseudo_cls0 = np.asarray(pseudo_cls0 + [0] * (Pp - n_pseudo))

        # slots per pseudo (valid class count) and member rep contexts
        n_slot = np.minimum(np.maximum(
            n_cls[pseudo_real] - pseudo_cls0, 0), cap)
        n_slot[n_pseudo:] = 0
        reps = np.zeros((Pp, cap), np.int64)
        for bp in range(n_pseudo):
            b = pseudo_real[bp]
            for cc in range(cap):
                k = pseudo_cls0[bp] + min(cc, max(int(n_slot[bp]) - 1, 0))
                members = np.where(cls_of[b] == k)[0]
                reps[bp, cc] = members[0]

        # --- bi2lane: biphone (x*P + y) -> collapsed lane --------------
        x = np.arange(B) // P
        y = np.arange(B) % P
        k_of = cls_of[x, y]
        bp_of = base_of[x] + k_of // cap
        bi2lane = (k_of % cap) * Pp + bp_of
        self._bi2lane_np = bi2lane.astype(np.int64)

        # --- observation tables: distinct pdfs per (pseudo, state),
        # first-use (band-major) ordered
        lists = {}
        k_max = 1
        for bp in range(Pp):
            b = pseudo_real[bp]
            for s in range(3):
                plane = pdf[:, b, :, s][:, reps[bp]]      # (P, cap)
                flat = plane.reshape(-1)
                _, first = np.unique(flat, return_index=True)
                distinct = flat[np.sort(first)]
                remap = {v: i for i, v in enumerate(distinct)}
                sel_plane = np.vectorize(remap.__getitem__)(plane)
                lists[(bp, s)] = (distinct, sel_plane)
                k_max = max(k_max, len(distinct))
        K8 = _ceil(k_max, 8)
        table = np.zeros((3, K8, Pp), np.int32)
        sel = np.zeros((3, PS, L), np.int32)
        for bp in range(Pp):
            for s in range(3):
                distinct, sel_plane = lists[(bp, s)]
                table[s, :len(distinct), bp] = distinct
                lanes = np.arange(cap) * Pp + bp
                sel[s, :P, lanes] = sel_plane.T       # (cap, P) -> rows
        # pdf id per (state, row, lane): what the TPU kernel's obs_plane
        # selects from the per-frame vals table, pad rows/lanes included
        lane_bp_all = np.arange(L) % Pp
        pdf_plane = np.take_along_axis(
            table[:, :, lane_bp_all], sel, axis=1)          # (3, PS, L)

        # --- transition planes ----------------------------------------
        tps = np.full((6, PS, L), NEG_INF, dtype=np.float32)
        for bp in range(n_pseudo):
            b = pseudo_real[bp]
            for cc in range(cap):
                lane = cc * Pp + bp
                r = reps[bp, cc]
                for s in range(3):
                    tps[s, :P, lane] = tps_c[:, b, r, s]
                    tps[3 + s, :P, lane] = tpt_c[:, b, r, s]

        # --- entry rearrangement + lm/start/beam constants -------------
        lanes = np.arange(L)
        lane_bp = lanes % Pp
        lane_cc = lanes // Pp
        lane_x = pseudo_real[lane_bp]                 # real center
        lane_k = pseudo_cls0[lane_bp] + lane_cc       # class id (if valid)
        lane_valid = (lane_bp < n_pseudo) & (lane_cc < n_slot[lane_bp])

        # src[a, bp]: the lane whose exported score enters (a, real(bp)),
        # i.e. the single nonzero term of the TPU kernel's one-hot
        # (Ea * pc) @ Fb product; -1 where that product is all zeros
        src = np.full((PS, Pp), -1, np.int32)
        for bp in range(n_pseudo):
            yb = int(pseudo_real[bp])
            src[:P, bp] = self._bi2lane_np[np.arange(P) * P + yb]

        lm = image.lm.astype(np.float32) * np.float32(lmw)
        lmq = np.full((PS, Pp), NEG_INF, dtype=np.float32)
        for bp in range(n_pseudo):
            yb = int(pseudo_real[bp])
            lmq[:P, bp] = lm[np.arange(P) * P + yb]

        # per-lane max member lm (beam row-max) and start mass
        starts = np.zeros(B, bool)
        starts[np.asarray(image.start_idxs)] = True
        lmmax = np.full(L, NEG_INF, np.float32)
        p0 = np.full(L, NEG_INF, np.float32)
        for j in range(L):
            if not lane_valid[j]:
                continue
            xj = int(lane_x[j])
            members = np.where(cls_of[xj] == lane_k[j])[0]
            bis = xj * P + members
            lmmax[j] = lm[bis].max()
            st = starts[bis]
            if st.any() != st.all():
                raise UnsupportedImage(
                    "start biphones not class-consistent")
            if st.all():
                p0[j] = -np.log(np.float32(P))

        lmend = np.zeros(Pp, np.float32)
        for p in range(P):
            lmend[int(base_of[p])] = lm[p * P + r_end]

        self._pip = float(pip)
        self._beam = float(beam) if beam is not None and beam > 0 else None

        dev = self.device
        as_t = lambda a, dt: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a)).to(dtype=dt, device=dev)
        self.bi2lane = as_t(bi2lane, torch.int64)
        self.pc0_map = as_t(base_of, torch.int64)
        self.pdf = as_t(pdf_plane, torch.int32)       # (3, PS, L)
        self.tps = as_t(tps, torch.float32)           # (6, PS, L)
        self.src = as_t(src, torch.int32)             # (PS, Pp)
        self.lmq = as_t(lmq, torch.float32)           # (PS, Pp)
        self.lmmax = as_t(lmmax, torch.float32)       # (L,)
        self.lmend = as_t(lmend, torch.float32)       # (Pp,)
        self.p0 = as_t(p0, torch.float32)             # (L,)
        self.plan = viterbi_cluster_plan(PS, L, self.S)
        if self.plan.route == "cluster":
            lane_bp_cells = np.broadcast_to(lane_bp, (PS, L))
            src_cells = np.take_along_axis(src, lane_bp_cells, axis=1)
            self.records = as_t(cluster_records(pdf_plane, tps, src_cells),
                                torch.int32)          # (8 PS L,)
            self.lmq_cells = as_t(cell_order(np.take_along_axis(
                lmq, lane_bp_cells, axis=1)), torch.float32)  # (PS L,)

    # ------------------------------------------------------------------
    def packed_to_full(self, packed_c: np.ndarray) -> np.ndarray:
        """Expand (..., L) collapsed packed rows to the XLA path's
        (..., B) ``tri * pack + t_entry + 1`` layout (tests; requires
        the XLA path to use the same pack factor)."""
        P = self.P
        v = np.asarray(packed_c)[..., self._bi2lane_np]      # (..., B)
        a = v // self.pack
        rest = v % self.pack
        b = np.arange(self.B) // P
        c = np.arange(self.B) % P
        if self.cube_order == "bac":
            tri = b * P * P + a * P + c
        else:
            tri = a * P * P + b * P + c
        return (tri * self.pack + rest).astype(np.int32)

    def forward(self, lp: torch.Tensor, lengths=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(U, T, S) float32 log-posteriors -> (packed (U, T, L) int32,
        end (U, T, P) float32). CUDA tensors launch the kernel (or
        raise); CPU tensors take the plain version."""
        if lengths is None:
            lengths = torch.full((lp.shape[0],), lp.shape[1],
                                 dtype=torch.int32)
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=lp.device)
        if lp.device.type == "cpu":
            return collapsed_viterbi_reference(self, lp, lengths)
        return collapsed_viterbi_forward(self, lp, lengths)


def collapsed_viterbi_reference(ck: CollapsedViterbi, lp: torch.Tensor,
                                lengths: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: every frame of every
    utterance, batched over utterances, with the TPU kernel's float32
    operation order (one IEEE add per step, strict ``>`` updates,
    first-max export over left contexts)."""
    U, T, S = lp.shape
    PS, L, Pp, cap, P = ck.PS, ck.L, ck.Pp, ck.cap, ck.P
    dev = lp.device
    lp = lp.float()
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    tps = ck.tps
    has_src = ck.src >= 0
    src = ck.src.clamp(min=0).long()
    pdf = ck.pdf.long().reshape(-1)
    pip = torch.full((), ck._pip, dtype=torch.float32, device=dev)
    pack_base = (torch.arange(PS, device=dev, dtype=torch.int32)
                 * ck.pack + 1)[:, None]                      # (PS, 1)
    int_max = torch.full((), 2 ** 31 - 1, dtype=torch.int32, device=dev)

    pp = torch.full((U, 3, PS, L), NEG_INF, dtype=torch.float32, device=dev)
    tt = torch.zeros((U, 3, PS, L), dtype=torch.int32, device=dev)
    pc = ck.p0.expand(U, L).clone()
    thr = torch.full((U, 1, 1), THR0, dtype=torch.float32, device=dev)
    packed = torch.empty((U, T, L), dtype=torch.int32, device=dev)
    end = torch.empty((U, T, Pp), dtype=torch.float32, device=dev)
    for k in range(T):
        # entry: exact gather in place of the one-hot matmul
        q = torch.where(has_src, pc[:, src], 0.0) + ck.lmq    # (U, PS, Pp)
        if ck._beam is not None:
            q = torch.where(q >= thr, q, neg)
        p_in = (q + pip).repeat(1, 1, cap)                    # (U, PS, L)
        obs = lp[:, k, pdf].reshape(U, 3, PS, L)
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

        # export: first-max over left-context rows
        out_score = pp2 + tps[5]                              # (U, PS, L)
        mx = out_score.amax(dim=1, keepdim=True)
        key = torch.where(out_score == mx, pack_base + tt2, int_max
                          ).amin(dim=1)                       # (U, L)
        packed[:, k] = key
        pnew = mx[:, 0]                                       # (U, L)
        if ck._beam is not None:
            rowm = (pnew + ck.lmmax).amax(dim=1)
            thr = (rowm - torch.full((), ck._beam, dtype=torch.float32,
                                       device=dev))[:, None, None]
        endrow = pnew[:, :Pp] + ck.lmend
        if ck._beam is not None:
            endrow = torch.where(endrow >= thr[:, 0], endrow, neg)
        end[:, k] = endrow
        pc = pnew
    return packed, end[:, :, ck.pc0_map]


_ARGTYPES = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p])
_CLUSTER_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                     + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_CAPACITY_ARGTYPES = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]


def _lib():
    lib = kernels.load("viterbi_collapsed")
    lib.collapsed_viterbi_forward.argtypes = _ARGTYPES
    lib.collapsed_viterbi_forward.restype = ctypes.c_int
    lib.collapsed_viterbi_cluster.argtypes = _CLUSTER_ARGTYPES
    lib.collapsed_viterbi_cluster.restype = ctypes.c_int
    lib.collapsed_viterbi_cluster_capacity.argtypes = _CAPACITY_ARGTYPES
    lib.collapsed_viterbi_cluster_capacity.restype = ctypes.c_int
    return lib


def cluster_capacity(query, *layout: int) -> int:
    """How many clusters the card holds at once, from a
    ``*_cluster_capacity`` entry point ``query`` given the geometry and
    the plan's cluster size (and, for the Viterbi forwards, its register
    flag) (raises if it fails)."""
    out = ctypes.c_int(0)
    kernels.check(query(*layout, ctypes.byref(out)),
                  "cluster capacity query")
    return out.value


def collapsed_cluster_capacity(ck: CollapsedViterbi,
                               plan: Optional[ViterbiPlan] = None) -> int:
    """Clusters of ``plan`` (default ``ck.plan``) the card holds at
    once."""
    plan = ck.plan if plan is None else plan
    return cluster_capacity(_lib().collapsed_viterbi_cluster_capacity,
                            ck.PS, ck.L, ck.S, plan.cluster,
                            int(plan.registers))


def _route(name: str, plan: ViterbiPlan, route: Optional[str],
           geometry: Optional[Tuple[int, int, int]] = None,
           frames: int = 0) -> ViterbiPlan:
    """``plan`` for a decode of ``frames`` frames, or forced (card tests,
    chip_smoke.py and the bench time and check every route on images the
    plan gives a cluster): with ``route="global"`` the device-memory
    route; with ``route="shared"`` the plan's cluster with its state in
    shared memory, for a kernel that has a register route (``geometry``:
    its rows, lanes and pdfs). The register route's plan takes the
    shared-memory route for more than ``REG_FRAMES`` frames."""
    if route is None and plan.registers and frames > REG_FRAMES:
        route = "shared"
    if route is None:
        return plan
    if route == "global":
        return ViterbiPlan("global")
    if route == "shared" and geometry is not None \
            and plan.route == "cluster":
        return viterbi_cluster_plan(*geometry, registers=False)
    allowed = "None, 'shared' or 'global'" if geometry else "None or 'global'"
    raise ValueError(f"{name}: route must be {allowed} (with a cluster for "
                     f"'shared'), got {route!r}")


def _check_lp(name: str, tables: torch.Tensor, s: int, lp: torch.Tensor,
              lengths: torch.Tensor) -> None:
    if lp.device.type != "cuda":
        raise ValueError(f"{name}: lp on {lp.device}, needs a CUDA tensor")
    if tables.device != lp.device:
        raise ValueError(f"{name}: tables on {tables.device}, lp on "
                         f"{lp.device}")
    if lp.dtype != torch.float32 or lp.dim() != 3 or lp.shape[2] != s:
        raise ValueError(f"{name}: lp must be float32 (U, T, {s}), got "
                         f"{lp.dtype} {tuple(lp.shape)}")
    if not lp.is_contiguous():
        raise ValueError(f"{name}: lp must be contiguous")
    if lengths.shape != (lp.shape[0],) or lengths.dtype != torch.int32 \
            or lengths.device != lp.device:
        raise ValueError(f"{name}: lengths must be int32 (U,) on lp's "
                         f"device")


def collapsed_viterbi_forward(ck: CollapsedViterbi, lp: torch.Tensor,
                              lengths: torch.Tensor,
                              route: Optional[str] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CUDA kernel wrapper (``csrc/viterbi_collapsed.cu``) on ``ck.plan``'s
    route: one cluster (or, on the device-memory route, one block) per
    utterance walks its frames up to its length. Rows past an
    utterance's length are left unwritten. ``route="shared"`` forces the
    cluster route with the state in shared memory, ``route="global"`` the
    device-memory route (tests, chip_smoke.py and the bench)."""
    name = "collapsed_viterbi_forward"
    _check_lp(name, ck.tps, ck.S, lp, lengths)
    if lp.shape[1] >= ck.pack - 1:
        raise ValueError(f"{lp.shape[1]} frames need a pack factor > "
                         f"{ck.pack}")
    plan = _route(name, ck.plan, route, (ck.PS, ck.L, ck.S), lp.shape[1])
    stream = torch.cuda.current_stream(lp.device).cuda_stream
    return _collapsed_launch(ck, lp, lengths, plan, _lib(), stream)


def _collapsed_launch(ck: CollapsedViterbi, lp: torch.Tensor,
                      lengths: torch.Tensor, plan: ViterbiPlan, lib, stream
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The outputs (and, on the device-memory route, the scratch) of one
    launch of ``plan``'s route through ``lib``'s entry points."""
    U, T, S = lp.shape
    PS, L, P = ck.PS, ck.L, ck.P
    dev = lp.device
    pc0 = ck.pc0_map.to(torch.int32)
    packed = torch.empty((U, T, L), dtype=torch.int32, device=dev)
    end = torch.empty((U, T, P), dtype=torch.float32, device=dev)
    use_beam = int(ck._beam is not None)
    beam = ck._beam if use_beam else 0.0
    if plan.route == "cluster":
        order = longest_first(lengths)
        status = lib.collapsed_viterbi_cluster(
            lp.data_ptr(), lengths.data_ptr(), order.data_ptr(),
            ck.records.data_ptr(), ck.lmq_cells.data_ptr(),
            ck.lmmax.data_ptr(), ck.lmend.data_ptr(), ck.p0.data_ptr(),
            pc0.data_ptr(), packed.data_ptr(), end.data_ptr(), U, T, S, P,
            PS, L, ck.pack, ck._pip, beam, use_beam, plan.cluster,
            int(plan.registers), stream)
        name = "collapsed_viterbi_forward"
    else:
        pp = torch.empty((U, 3, PS, L), dtype=torch.float32, device=dev)
        tt = torch.empty((U, 3, PS, L), dtype=torch.int32, device=dev)
        status = lib.collapsed_viterbi_forward(
            lp.data_ptr(), lengths.data_ptr(), ck.pdf.data_ptr(),
            ck.tps.data_ptr(), ck.src.data_ptr(), ck.lmq.data_ptr(),
            ck.lmmax.data_ptr(), ck.lmend.data_ptr(), ck.p0.data_ptr(),
            pc0.data_ptr(), pp.data_ptr(), tt.data_ptr(), packed.data_ptr(),
            end.data_ptr(), U, T, S, P, PS, L, ck.Pp, ck.pack, ck._pip, beam,
            use_beam, stream)
        name = "collapsed_viterbi_forward.global"
    kernels.check(status, name)
    kernels.launches[name] += 1
    if plan.registers:
        kernels.launches[f"{name}.registers"] += 1
    return packed, end
