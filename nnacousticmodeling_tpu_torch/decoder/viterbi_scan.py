"""The scan twins' forward as one CUDA kernel a decode: the wrapper, the
host tables it reads, and its launch count.

Counterpart of the JAX decoder's scan twins, ``_forward_scan_cube``
(``viterbi.py:370-445``) and ``_forward_scan`` (``:447-500``):
``lax.scan``s that XLA compiles into one program under
``jax.jit(jax.vmap(_decode_device))``. The JAX package has no Pallas
kernel here; the port's is ``csrc/viterbi_scan.cu``, one launch for all
T frames of all U utterances. Its plain versions are the decoder's two
frame loops (``ViterbiDecoder._forward_scan_cube`` and
``_forward_scan_general``), which CPU tensors take;
``ViterbiDecoder._forward_scan`` launches the kernel for CUDA tensors, on
cube and non-cube images alike, and a build or launch failure raises.

The kernel has two routes with the same bits, and ``scan_cluster_plan``
picks one from the image's shape, never after a failure: the cluster
route keeps each utterance's DP state in the shared memory of a cluster
of blocks (the 48-phone image takes 16), reading each slot's tables as
32 bytes of records (``scan_records``); the device-memory route (the
first kernel) keeps it in a (U, F, B) scratch, where no cluster holds a
slice or an id needs more than 16 bits. ``kernels.launches`` counts
``viterbi_scan_forward`` (cluster) apart from
``viterbi_scan_forward.global``; ``route="global"`` forces the latter.

The kernel reads the image's dense fan-in (``HmmImage.dense_fanin``:
each biphone's feeding triphones in CSR order, F slots a biphone) in a
slot-major (F, B) layout, so that the threads owning neighbouring
biphones read neighbouring words: ``idx`` (the three pdf ids and the
in-biphone of the triphone in each slot), ``tpa`` / ``tpb`` (its
self-loop and transition log-probabilities) and ``fan`` (its id, for
the packed backpointer). A thread that owns biphone b updates the three
states of b's triphones and takes their first max in slot order, which
is the general twin's export; on a dense cube the fan-in rows run over
the left context in ascending order, so the cube twin's bits come out
too. Every triphone must sit in exactly one fan-in row (``zero_slot``
< 0 marks an image where it does not; the wrapper refuses it). Two
exports read another thread's triphone, as the twins' do: an empty row
exports triphone 0 with its new entry time, and a row with padding whose
valid slots all score below NEG_INF exports the padding id -1 with the
last triphone's (JAX indexes -1 from the end); the owners of those two
triphones publish their entry times each frame.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .. import kernels
from .image import HmmImage
from .viterbi_collapsed import (
    CLUSTER_SIZES,
    LANE_CHUNK,
    MAX_WARPS,
    SMEM_LIMIT,
    ViterbiPlan,
    _ceil,
    _route,
    cluster_capacity,
    cluster_records,
)

#: the device-memory route's largest block, and the most biphones a
#: thread may own
MAX_THREADS = 1024
MAX_BIPHONES_A_THREAD = 32
#: the cluster route: threads a biphone (a warp owns LANE_CHUNK biphones),
#: the most chunks a warp walks (one mask bit each), the widest ids
SLOT_GROUPS = 4
MAX_CHUNKS_A_WARP = 32
MAX_PDFS = 1 << 16
MAX_BIPHONES = 1 << 15


def scan_slice(b: int, c: int) -> int:
    """Biphones a block of a c-block cluster owns: B / c rounded up to a
    whole chunk (``slice_of`` of csrc/viterbi_scan.cu)."""
    return _ceil(-(-b // c), LANE_CHUNK)


def scan_cluster_smem_bytes(f: int, b: int, s: int, c: int) -> int:
    """Shared memory of one cluster-route block (``cluster_smem`` of
    csrc/viterbi_scan.cu): the state of its slice's slots (score and entry
    time a state, F rounded up to 4), two full score rows, two posterior
    rows, and 16 words of entry times, row maxima and thresholds."""
    w = scan_slice(b, c)
    return (3 * _ceil(f, 4) * w * 8 + 2 * c * w * 4 + 2 * _ceil(s, 4) * 4
            + 16 * 4)


def scan_cluster_plan(f: int, b: int, s: int,
                      smem_limit: int = SMEM_LIMIT) -> ViterbiPlan:
    """The route of a scan of fan-in width ``f``, ``b`` biphones and ``s``
    pdfs: the smallest cluster in ``CLUSTER_SIZES`` whose blocks each
    hold their slice and rows in ``smem_limit`` bytes; the device-memory
    route where none does or where a pdf id or an in-biphone does not fit
    its 16-bit record field. Pure host arithmetic."""
    if s <= MAX_PDFS and b <= MAX_BIPHONES:
        for c in CLUSTER_SIZES:
            w = scan_slice(b, c)
            threads = 32 * min(w // LANE_CHUNK, MAX_WARPS)
            if w // LANE_CHUNK > MAX_CHUNKS_A_WARP * (threads // 32):
                continue
            smem = scan_cluster_smem_bytes(f, b, s, c)
            if smem <= smem_limit:
                return ViterbiPlan("cluster", c, w, threads, smem)
    return ViterbiPlan("global")


def scan_records(idx: np.ndarray, tpa: np.ndarray, tpb: np.ndarray
                 ) -> np.ndarray:
    """The cluster route's slot records from the slot-major (F, B) tables,
    padded to (F rounded up to 4, B rounded up to 8), in
    ``cluster_records``' layout: self-loops 1-2 and transitions 0-1 (an
    int4 a slot), transition 2 with pdf 1 | pdf 2 << 16 (an int2), and
    self-loop 0 with pdf 0 | in-biphone << 16 (an int2); the slots of a
    warp's step (4 slots of 8 biphones) contiguous."""
    f, b = idx.shape[:2]
    pad = ((0, _ceil(f, 4) - f), (0, _ceil(b, LANE_CHUNK) - b))
    plane = lambda x: np.pad(x, pad)  # noqa: E731
    tps = np.stack([plane(tpa[..., q]) for q in range(4)]
                   + [plane(tpb[..., q]) for q in range(2)])
    pdf = np.stack([plane(idx[..., q]) for q in range(3)])
    return cluster_records(pdf, tps, plane(idx[..., 3]))


@dataclass(frozen=True)
class ScanTables:
    """The kernel's view of one decoder's image, built once per decoder.
    ``count`` (B,) int32: slots in use a biphone; ``idx`` (F, B, 4)
    int32: pdf ids of states 0-2 and the in-biphone; ``tpa`` (F, B, 4)
    float32: self-loops 0-2 and transition 0; ``tpb`` (F, B, 2):
    transitions 1-2; ``fan`` (F, B) int32: triphone ids (0 in padding);
    ``lm`` (B,) the LM row times lmw; ``p0`` (B,) the initial scores;
    ``end_idxs`` (P,) int32; ``zero_slot`` / ``last_slot``: j * B + b of
    the slots of triphone 0 and of the last triphone, -1 where the fan-in
    rows do not list each triphone once; ``plan``: the kernel's route
    (``scan_cluster_plan``); ``records``: the cluster route's slot records
    (``scan_records``, int32), None on the device-memory route."""

    num_phones: int
    num_states: int
    num_triphones: int
    count: torch.Tensor
    idx: torch.Tensor
    tpa: torch.Tensor
    tpb: torch.Tensor
    fan: torch.Tensor
    lm: torch.Tensor
    p0: torch.Tensor
    end_idxs: torch.Tensor
    zero_slot: int
    last_slot: int
    pip: float
    beam: Optional[float]
    plan: ViterbiPlan
    records: Optional[torch.Tensor]

    @property
    def width(self) -> int:
        return self.fan.shape[0]

    @property
    def num_biphones(self) -> int:
        return self.fan.shape[1]


def scan_tables(image: HmmImage, lm: np.ndarray, p0: np.ndarray, pip: float,
                beam: Optional[float], device) -> ScanTables:
    """The slot-major tables of ``image`` on ``device``; ``lm`` and ``p0``
    are the decoder's float32 rows (LM times lmw, initial scores)."""
    fanin = image.dense_fanin()                      # (B, F), -1 pad
    valid = (fanin >= 0).T                           # (F, B)
    tri = np.where(valid, fanin.T, 0)
    idx = np.zeros(tri.shape + (4,), np.int32)
    idx[..., :3] = image.state_idxs[tri]
    idx[..., 3] = image.biphone_in[tri]
    tp_self = np.asarray(image.tp_selfloop, np.float32)
    tp_trans = np.asarray(image.tp_transition, np.float32)
    tpa = np.zeros(tri.shape + (4,), np.float32)
    tpa[..., :3] = tp_self[tri]
    tpa[..., 3] = tp_trans[tri, 0]
    tpb = tp_trans[tri][..., 1:]
    zero_slot = last_slot = -1
    t3 = image.num_triphones
    if np.array_equal(np.sort(image.out_values), np.arange(t3)):
        def slot(t):
            j, b = np.argwhere(valid & (tri == t))[0]
            return int(j) * tri.shape[1] + int(b)
        zero_slot, last_slot = slot(0), slot(t3 - 1)
    plan = scan_cluster_plan(tri.shape[0], tri.shape[1], image.num_states)

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return ScanTables(
        num_phones=image.num_phones, num_states=image.num_states,
        num_triphones=t3, count=dev(valid.sum(axis=0), torch.int32),
        idx=dev(idx, torch.int32), tpa=dev(tpa, torch.float32),
        tpb=dev(tpb, torch.float32), fan=dev(tri, torch.int32),
        lm=dev(lm, torch.float32), p0=dev(p0, torch.float32),
        end_idxs=dev(image.end_idxs, torch.int32), zero_slot=zero_slot,
        last_slot=last_slot, pip=float(pip), beam=beam, plan=plan,
        records=(dev(scan_records(idx, tpa, tpb), torch.int32)
                 if plan.route == "cluster" else None))


def launch_shape(num_biphones: int) -> Tuple[int, int]:
    """(threads a block, biphones a thread): the fewest biphones a
    thread that a block of at most MAX_THREADS holds, spread evenly over
    whole warps."""
    bpt = max(1, -(-num_biphones // MAX_THREADS))
    threads = -(-num_biphones // bpt)
    return -(-threads // 32) * 32, bpt


_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 11
             + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p])
_CLUSTER_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                     + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                        ctypes.c_void_p])
_CAPACITY_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]


def _lib():
    lib = kernels.load("viterbi_scan")
    lib.viterbi_scan_forward.argtypes = _ARGTYPES
    lib.viterbi_scan_forward.restype = ctypes.c_int
    lib.viterbi_scan_cluster.argtypes = _CLUSTER_ARGTYPES
    lib.viterbi_scan_cluster.restype = ctypes.c_int
    lib.viterbi_scan_cluster_capacity.argtypes = _CAPACITY_ARGTYPES
    lib.viterbi_scan_cluster_capacity.restype = ctypes.c_int
    return lib


def scan_cluster_capacity(tables: ScanTables) -> int:
    """Clusters of ``tables``' plan the card holds at once."""
    return cluster_capacity(_lib().viterbi_scan_cluster_capacity,
                            tables.width, tables.num_biphones,
                            tables.num_states, tables.plan.cluster)


def viterbi_scan_forward(tables: ScanTables, lp: torch.Tensor, pack: int,
                         route: Optional[str] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CUDA kernel wrapper (``csrc/viterbi_scan.cu``) on ``tables.plan``'s
    route: (U, T, S) float32 log-posteriors -> packed (U, T, B) int32
    ``tri * pack + t_entry + 1`` in original biphone order and end scores
    (U, T, P) float32, every frame of every utterance, bit-equal to the
    scan twins. One cluster an utterance keeps its DP state on chip; on
    the device-memory route one block an utterance keeps it in a (U, F,
    B) scratch of 24 bytes a slot. ``route="global"`` forces the
    device-memory route (tests and chip_smoke.py). One launch, no
    synchronisation."""
    name = "viterbi_scan_forward"
    plan = _route(name, tables.plan, route)
    if lp.device.type != "cuda":
        raise ValueError(f"{name}: lp on {lp.device}, needs a CUDA tensor")
    S, B, F, P = (tables.num_states, tables.num_biphones, tables.width,
                  tables.num_phones)
    if (lp.dtype != torch.float32 or lp.dim() != 3 or lp.shape[2] != S
            or not lp.is_contiguous()):
        raise ValueError(f"{name}: lp must be a contiguous float32 (U, T, "
                         f"{S}) tensor, got {lp.dtype} {tuple(lp.shape)}")
    dev = lp.device
    if tables.idx.device != dev:
        raise ValueError(f"{name}: tables on {tables.idx.device}, lp on "
                         f"{dev}")
    if min(tables.zero_slot, tables.last_slot) < 0:
        raise ValueError(f"{name}: the image's fan-in rows do not list each "
                         f"triphone exactly once")
    shapes = {"count": (B,), "idx": (F, B, 4), "tpa": (F, B, 4),
              "tpb": (F, B, 2), "lm": (B,), "p0": (B,), "end_idxs": (P,)}
    for key, shape in shapes.items():
        t = getattr(tables, key)
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: table {key} is {tuple(t.shape)}, "
                             f"expected a contiguous {shape}")
    U, T, _ = lp.shape
    pack = int(pack)
    if not T < pack or tables.num_triphones * pack >= 2 ** 31:
        raise ValueError(f"{name}: pack factor {pack} does not hold {T} "
                         f"frames of {tables.num_triphones} triphones in "
                         f"int32")
    if plan.route == "cluster":
        n = 8 * _ceil(F, 4) * _ceil(B, LANE_CHUNK)
        rec = tables.records
        if (rec is None or tuple(rec.shape) != (n,)
                or rec.dtype != torch.int32 or not rec.is_contiguous()):
            raise ValueError(f"{name}: table records must be a contiguous "
                             f"int32 ({n},) tensor")
    elif launch_shape(B)[1] > MAX_BIPHONES_A_THREAD:
        raise ValueError(f"{name}: {B} biphones exceed "
                         f"{MAX_THREADS * MAX_BIPHONES_A_THREAD}")
    packed = torch.empty((U, T, B), dtype=torch.int32, device=dev)
    end = torch.empty((U, T, P), dtype=torch.float32, device=dev)
    if U == 0 or T == 0:
        return packed, end
    stream = torch.cuda.current_stream(dev).cuda_stream
    return _scan_launch(tables, lp, pack, plan, _lib(), stream, packed, end)


def _scan_launch(tables: ScanTables, lp: torch.Tensor, pack: int,
                 plan: ViterbiPlan, lib, stream, packed: torch.Tensor,
                 end: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``plan``'s route through ``lib``'s entry points into
    ``packed`` and ``end`` (and, on the device-memory route, a scratch it
    allocates); counts the launch under the route's name."""
    U, T, S = lp.shape
    B, F, P = tables.num_biphones, tables.width, tables.num_phones
    beam = tables.beam
    common = (U, T, S, B, F, P, tables.zero_slot, tables.last_slot, pack)
    tail = (tables.pip, 0.0 if beam is None else beam, int(beam is not None),
            stream)
    if plan.route == "cluster":
        name = "viterbi_scan_forward"
        status = lib.viterbi_scan_cluster(
            lp.data_ptr(), tables.records.data_ptr(), tables.fan.data_ptr(),
            tables.count.data_ptr(), tables.lm.data_ptr(),
            tables.p0.data_ptr(), tables.end_idxs.data_ptr(),
            packed.data_ptr(), end.data_ptr(), *common, plan.cluster, *tail)
    else:
        name = "viterbi_scan_forward.global"
        threads, bpt = launch_shape(B)
        dev = lp.device
        st_a = torch.empty((U, F, B, 4), dtype=torch.int32, device=dev)
        st_b = torch.empty((U, F, B, 2), dtype=torch.int32, device=dev)
        status = lib.viterbi_scan_forward(
            lp.data_ptr(), tables.idx.data_ptr(), tables.tpa.data_ptr(),
            tables.tpb.data_ptr(), tables.fan.data_ptr(),
            tables.count.data_ptr(), tables.lm.data_ptr(),
            tables.p0.data_ptr(), tables.end_idxs.data_ptr(),
            st_a.data_ptr(), st_b.data_ptr(), packed.data_ptr(),
            end.data_ptr(), *common, threads, bpt, *tail)
    kernels.check(status, name)
    kernels.launches[name] += 1
    return packed, end
