"""The Viterbi backtrace of every decoder backend: CUDA kernel wrapper,
its plain PyTorch version, and the tables they share.

Counterpart of the JAX decoder's backtraces (``_collapsed_backtrace``,
``viterbi.py:217-260``; ``_device_backtrace``, ``:503-544``, which
``_pallas_backtrace`` also takes), ``jax.lax.while_loop``s that XLA
compiles into one program with the forward. The JAX package has no
Pallas kernel here; the port's is ``csrc/viterbi_backtrace.cu``, so a
decode on the card is the forward kernel and then this one, queued with
no host round-trip. ``backtrace`` takes it for CUDA tensors (a build or
launch failure raises) and the plain version for CPU tensors.

A walk starts at the end of ``end_map[first max of the last end row]``
and hops back through ``tri * pack + t_entry + 1`` (lane-map mode: the
cube kernel's and the scan twins' rows) or ``a* * pack + t_entry + 1``
(collapsed modes, one per cube order) entries, C++
``phone_recog.cpp:224-244``. Results: segs (U, T, 3) int32 [begin,
end, triphone] from index 0 = LAST segment, zero past the count, and
counts (U,) int64.

The kernel unpacks with a shift and a mask, so ``pack`` must be a power
of two (``pack_shift``; the decoder makes no other kind, and the plain
version stays general). It stages the collapsed modes' tables in shared
memory once a block. The lane map has two routes, one counter
(``viterbi_backtrace``): ``shared`` stages an int16 copy of its table
where it fits (P <= 48), ``global`` reads the int32 table from device
memory; ``backtrace_route`` picks.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .. import kernels
from ..ops.rnn_cuda import SMEM_LIMIT

#: walk modes (the kernel's ``mode`` argument)
LANES, COLLAPSED_BAC, COLLAPSED_ABC = 0, 1, 2
#: the plain version's host check for finished walks, once per this many
#: hops (with ``early_exit``)
_BACKTRACE_SYNC_EVERY = 16
#: the kernel's routes (its ``route`` argument); the collapsed modes take
#: ``shared`` only
ROUTES = {"shared": 0, "global": 1}


@dataclass(frozen=True)
class BacktraceTables:
    """One backend's walk tables, built once per decoder. ``end_map``:
    end phone -> lane (lane-map mode) or biphone (collapsed modes);
    ``step_map``: triphone -> predecessor lane (lane-map mode) or
    biphone -> collapsed lane (``bi2lane``). The int64 tables index the
    plain walk; ``end_map32`` / ``step_map32`` are the kernel's copies,
    and ``step_map16`` the lane-map table as int16 for the shared route
    (None in collapsed modes and where a value does not fit int16)."""

    mode: int
    num_phones: int
    end_map: torch.Tensor
    step_map: torch.Tensor
    end_map32: torch.Tensor
    step_map32: torch.Tensor
    step_map16: Optional[torch.Tensor] = None


def backtrace_tables(mode: int, num_phones: int, end_map: torch.Tensor,
                     step_map: torch.Tensor) -> BacktraceTables:
    step16 = None
    if (mode == LANES and step_map.numel()
            and int(step_map.min()) >= -2 ** 15
            and int(step_map.max()) < 2 ** 15):
        step16 = step_map.to(torch.int16).contiguous()
    return BacktraceTables(
        mode, num_phones, end_map, step_map,
        end_map.to(torch.int32).contiguous(),
        step_map.to(torch.int32).contiguous(), step16)


def pack_shift(pack: int) -> int:
    """log2 of the pack factor, which the kernel unpacks with a shift and
    a mask: a power of two from 1 to 2**30 (``ViterbiDecoder._grow_pack``
    makes no other kind). ValueError otherwise."""
    pack = int(pack)
    if not 0 < pack < 2 ** 31 or pack & (pack - 1):
        raise ValueError(f"viterbi_backtrace: pack factor {pack} is not a "
                         f"power of two below 2**31")
    return pack.bit_length() - 1


def shared_table_bytes(tables: BacktraceTables) -> Optional[int]:
    """Shared memory the shared route stages (end_map, 16-byte aligned,
    then the step table), or None where it has no table to stage."""
    step = (tables.step_map16 if tables.mode == LANES
            else tables.step_map32)
    if step is None:
        return None
    end = -(-4 * tables.end_map32.numel() // 16) * 16
    return end + step.numel() * step.element_size()


def backtrace_route(tables: BacktraceTables) -> str:
    """``shared`` for the collapsed modes, and for a lane map whose int16
    copy fits a block's shared memory; else ``global``."""
    if tables.mode != LANES:
        return "shared"
    need = shared_table_bytes(tables)
    return "shared" if need is not None and need <= SMEM_LIMIT else "global"


def backtrace_routes(tables: BacktraceTables) -> Tuple[str, ...]:
    """Every route a walk of these tables can take: the collapsed modes'
    one, the lane map's ``global`` and, where its table fits,
    ``shared``."""
    if tables.mode != LANES:
        return ("shared",)
    return tuple(dict.fromkeys((backtrace_route(tables), "global")))


def backtrace(tables: BacktraceTables, packed: torch.Tensor,
              end_scores: torch.Tensor, lengths: torch.Tensor, pack: int,
              early_exit: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(segs, counts) of every utterance: the kernel for CUDA tensors
    (``early_exit`` has no meaning there: the kernel ends each walk on
    its own), the plain version for CPU tensors."""
    if packed.device.type == "cpu":
        return viterbi_backtrace_reference(tables, packed, end_scores,
                                           lengths, pack, early_exit)
    return viterbi_backtrace(tables, packed, end_scores, lengths, pack)


def viterbi_backtrace_reference(tables: BacktraceTables,
                                packed: torch.Tensor,
                                end_scores: torch.Tensor,
                                lengths: torch.Tensor, pack: int,
                                early_exit: bool = True
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, all utterances at once on
    their device. Every hop moves an unfinished utterance to an earlier
    frame, so T hops finish every walk. With ``early_exit`` the host
    reads whether any walk is left once every ``_BACKTRACE_SYNC_EVERY``
    hops and stops when none is (a synchronising read); without it the
    walk runs all T hops, each a no-op for finished utterances, and never
    waits for the device."""
    P = tables.num_phones
    step_map = tables.step_map
    if tables.mode == LANES:
        def lane_of(cur):
            return cur

        def step(entry, cur):
            tri = torch.div(entry, pack, rounding_mode="floor")
            return tri, torch.remainder(entry, pack) - 1, step_map[tri]
    else:
        bac = tables.mode == COLLAPSED_BAC

        def lane_of(bi):
            return step_map[bi]

        # the collapsed lane loses the right context, but the walk always
        # knows the real biphone it traces (the first hop starts from an
        # end biphone, each hop's predecessor is (a*, center)), so the
        # triphone id is rebuilt arithmetically
        def step(entry, bi):
            a = torch.div(entry, pack, rounding_mode="floor")
            b = torch.div(bi, P, rounding_mode="floor")
            cc = torch.remainder(bi, P)
            tri = b * (P * P) + a * P + cc if bac else a * (P * P) + b * P + cc
            return tri, torch.remainder(entry, pack) - 1, a * P + b

    U, T, _ = packed.shape
    dev = packed.device
    lengths = lengths.to(device=dev, dtype=torch.int64)
    rows = torch.arange(U, device=dev)
    last = end_scores[rows, (lengths - 1).clamp(min=0)]      # (U, P)
    cur = tables.end_map[last.argmax(dim=1)]         # first max wins
    t = lengths - 1
    k = torch.zeros(U, dtype=torch.int64, device=dev)
    segs = torch.zeros((U, T, 3), dtype=torch.int32, device=dev)
    minus1 = torch.full_like(t, -1)
    for hop in range(T):
        if (early_exit and hop % _BACKTRACE_SYNC_EVERY == 0
                and not bool((t >= 0).any())):
            break
        active = t >= 0
        # a finished (or empty) utterance reads a row the kernels may
        # have left unwritten: give its step a harmless entry (tri 0)
        entry = torch.where(
            active, packed[rows, t.clamp(min=0), lane_of(cur)].long(), 1)
        tri, t_new, nxt = step(entry, cur)
        row = torch.stack([t_new + 1, t + 1, tri], dim=1).to(torch.int32)
        slot = k.clamp(max=T - 1)
        segs[rows, slot] = torch.where(active[:, None], row,
                                       segs[rows, slot])
        cur = torch.where(active, nxt, cur)
        k = k + active.long()
        # degenerate guard: the native decoder loops forever when no
        # complete path exists (< 3 frames); this walk stops instead
        t = torch.where(active, torch.where(t_new >= t, minus1, t_new), t)
    return segs, k


_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
             + [ctypes.c_void_p])


def _lib():
    lib = kernels.load("viterbi_backtrace")
    lib.viterbi_backtrace.argtypes = _ARGTYPES
    lib.viterbi_backtrace.restype = ctypes.c_int
    return lib


def viterbi_backtrace(tables: BacktraceTables, packed: torch.Tensor,
                      end_scores: torch.Tensor, lengths: torch.Tensor,
                      pack: int, route: Optional[str] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CUDA kernel wrapper (``csrc/viterbi_backtrace.cu``): one warp an
    utterance zeroes its segs row, takes the first max of its last end
    row and walks, one dependent load of ``packed`` a hop. ``route``:
    ``backtrace_route``'s pick unless given; the decoder never gives it,
    the card tests and the benchmarks force each of ``backtrace_routes``.
    One launch, no host check, no synchronisation."""
    name = "viterbi_backtrace"
    if packed.device.type != "cuda":
        raise ValueError(f"{name}: packed on {packed.device}, needs a CUDA "
                         f"tensor")
    dev = packed.device
    if packed.dtype != torch.int32 or packed.dim() != 3:
        raise ValueError(f"{name}: packed must be int32 (U, T, lanes), got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    U, T, L = packed.shape
    E = tables.end_map32.numel()
    if (end_scores.dtype != torch.float32 or end_scores.device != dev
            or end_scores.shape != (U, T, E)):
        raise ValueError(f"{name}: end_scores must be float32 ({U}, {T}, "
                         f"{E}) on {dev}, got {end_scores.dtype} "
                         f"{tuple(end_scores.shape)} on {end_scores.device}")
    if not (packed.is_contiguous() and end_scores.is_contiguous()):
        raise ValueError(f"{name}: packed and end_scores must be contiguous")
    if tables.end_map32.device != dev:
        raise ValueError(f"{name}: tables on {tables.end_map32.device}, "
                         f"packed on {dev}")
    if lengths.shape != (U,) or lengths.is_floating_point():
        raise ValueError(f"{name}: lengths must be {U} integers, got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    shift = pack_shift(pack)
    P = tables.num_phones
    M = tables.step_map32.numel()
    if tables.mode != LANES and M != P * P:
        raise ValueError(f"{name}: a collapsed walk's table holds P*P = "
                         f"{P * P} biphones, got {M}")
    route = backtrace_route(tables) if route is None else route
    if route not in ROUTES:
        raise ValueError(f"{name}: unknown route {route!r}; one of "
                         f"{sorted(ROUTES)}")
    if tables.mode != LANES and route != "shared":
        raise ValueError(f"{name}: a collapsed walk's tables sit in shared "
                         f"memory; no {route!r} route")
    if route == "shared":
        need = shared_table_bytes(tables)
        if need is None or need > SMEM_LIMIT:
            raise ValueError(f"{name}: the tables do not fit the shared "
                             f"route ({need} bytes, limit {SMEM_LIMIT})")
    step = (tables.step_map16 if route == "shared" and tables.mode == LANES
            else tables.step_map32)
    lens = lengths.to(device=dev, dtype=torch.int32).contiguous()
    segs = torch.empty((U, T, 3), dtype=torch.int32, device=dev)
    counts = torch.empty((U,), dtype=torch.int64, device=dev)
    if U == 0:
        return segs, counts
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = _lib().viterbi_backtrace(
        packed.data_ptr(), end_scores.data_ptr(), lens.data_ptr(),
        tables.end_map32.data_ptr(), step.data_ptr(), segs.data_ptr(),
        counts.data_ptr(), U, T, L, E, M, P, shift, tables.mode,
        ROUTES[route], stream)
    kernels.check(status, name)
    kernels.launches[name] += 1
    return segs, counts
