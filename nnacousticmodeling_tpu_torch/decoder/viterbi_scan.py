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

#: the kernel's largest block, and the most biphones a thread may own
MAX_THREADS = 1024
MAX_BIPHONES_A_THREAD = 32


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
    rows do not list each triphone once."""

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
        last_slot=last_slot, pip=float(pip), beam=beam)


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


def _lib():
    lib = kernels.load("viterbi_scan")
    lib.viterbi_scan_forward.argtypes = _ARGTYPES
    lib.viterbi_scan_forward.restype = ctypes.c_int
    return lib


def viterbi_scan_forward(tables: ScanTables, lp: torch.Tensor, pack: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CUDA kernel wrapper (``csrc/viterbi_scan.cu``): (U, T, S) float32
    log-posteriors -> packed (U, T, B) int32 ``tri * pack + t_entry + 1``
    in original biphone order and end scores (U, T, P) float32, every
    frame of every utterance, bit-equal to the scan twins. One block an
    utterance walks the T frames; the DP state lives in a (U, F, B)
    scratch of 24 bytes a slot. One launch, no synchronisation."""
    name = "viterbi_scan_forward"
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
    threads, bpt = launch_shape(B)
    if bpt > MAX_BIPHONES_A_THREAD:
        raise ValueError(f"{name}: {B} biphones exceed "
                         f"{MAX_THREADS * MAX_BIPHONES_A_THREAD}")
    packed = torch.empty((U, T, B), dtype=torch.int32, device=dev)
    end = torch.empty((U, T, P), dtype=torch.float32, device=dev)
    if U == 0 or T == 0:
        return packed, end
    st_a = torch.empty((U, F, B, 4), dtype=torch.int32, device=dev)
    st_b = torch.empty((U, F, B, 2), dtype=torch.int32, device=dev)
    beam = tables.beam
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = _lib().viterbi_scan_forward(
        lp.data_ptr(), tables.idx.data_ptr(), tables.tpa.data_ptr(),
        tables.tpb.data_ptr(), tables.fan.data_ptr(),
        tables.count.data_ptr(), tables.lm.data_ptr(), tables.p0.data_ptr(),
        tables.end_idxs.data_ptr(), st_a.data_ptr(), st_b.data_ptr(),
        packed.data_ptr(), end.data_ptr(), U, T, S, B, F, P,
        tables.zero_slot, tables.last_slot, pack, threads, bpt, tables.pip,
        0.0 if beam is None else beam, int(beam is not None), stream)
    kernels.check(status, name)
    kernels.launches[name] += 1
    return packed, end
