"""Recurrences over a hoisted input projection -- the LSTM, the gated
family (GRU, minimal GRU with and without its reset gate) and the
peephole LSTM: CUDA kernel wrappers and their plain PyTorch versions,
for inference and training.

Counterpart of ``nnacousticmodeling_tpu/ops/rnn_pallas.py``:

- ``lstm_scan`` <- ``lstm_scan_pallas`` (twin ``lstm_scan_mixed_reference``),
  kernel ``csrc/lstm_scan.cu``; inference only, it has no backward;
- ``lstm_scan_train`` <- ``lstm_scan_pallas_train``, a
  ``torch.autograd.Function`` over ``lstm_train_forward``
  (<- ``_lstm_train_fwd_impl``) and ``lstm_train_backward``
  (<- ``_lstm_train_bwd_impl``, with its dW contraction
  ``lstm_train_dw``), kernels ``csrc/lstm_train.cu``;
- ``gated_scan`` <- ``gated_scan_pallas`` (twin
  ``gated_scan_mixed_reference``), kernel ``csrc/gated_scan.cu`` on
  ``csrc/gated_persistent.cuh``; inference only;
- ``gated_scan_train`` <- ``gated_scan_pallas_train``, a
  ``torch.autograd.Function`` over ``gated_train_forward``
  (<- ``_gated_train_fwd_impl``, the scan's kernel body plus the
  residuals) and ``gated_train_backward`` (<- ``_gated_train_bwd_impl``,
  with its dW1 / dW2 contractions ``gated_train_dw``), kernels
  ``csrc/gated_train.cu``;
- ``peephole_scan`` <- ``peephole_scan_pallas`` (twin
  ``peephole_scan_mixed_reference``), kernel ``csrc/peephole_scan.cu``;
  inference only;
- ``peephole_scan_train`` <- ``peephole_scan_pallas_train``, a
  ``torch.autograd.Function`` over ``peephole_train_forward``
  (<- ``_peep_train_fwd_impl``) and ``peephole_train_backward``
  (<- ``_peep_train_bwd_impl``, with its dW_h / dP_i / dP_f / dP_o
  contractions ``peephole_train_dw``), kernels
  ``csrc/peephole_train.cu``.

The sources say what bounds the kernels and how they are laid out.
Precision contract (the TPU kernels'): ``proj`` rounded to bf16 even
when it is float32, bf16 operands for the recurrent products with
float32 accumulation, float32 gates and carry, ``hs`` in proj's dtype,
the final carry in the initial carry's dtype. The gated kernels also
round the operand ``r*h`` of the product with w2 to bf16, the peephole
kernels the cell states ``c_{t-1}`` and ``c_t`` of theirs. Training
stores the residuals in bf16 (LSTM ``[a | i | f | o | tanh c_t | c_{t-1}
| h_{t-1}]``, gated ``[r | z | hb | h_prev]``, peephole the LSTM's row
and ``c_t``); ``dproj`` takes the unrounded float32 pre-activation
gradients in proj's dtype, while the products (dh, dc, dW) take their
bf16 roundings.

Each wrapper launches its kernel for CUDA tensors (or raises) and takes
its plain version only for CPU tensors. ``lstm_scan_plan``,
``lstm_train_bwd_plan``, ``gated_scan_plan``, ``gated_train_fwd_plan``,
``gated_train_bwd_plan``, ``peephole_scan_plan``,
``peephole_train_fwd_plan``, ``peephole_train_bwd_plan`` and ``dw_plan``
are the host-side layouts of the persistent LSTM recurrence
(``csrc/lstm_persistent.cuh``: ``lstm_scan`` and the training forward),
of the persistent LSTM training backward (``csrc/lstm_train.cu``), of
the persistent gated recurrence (``csrc/gated_persistent.cuh``:
``gated_scan`` and the training forward) and training backward
(``csrc/gated_train.cu``), of the persistent peephole recurrence
(``csrc/peephole_persistent.cuh``: ``peephole_scan`` and the training
forward) and training backward (``csrc/peephole_train.cu``) and of the
tensor-core dW GEMM shared by the three training backwards
(``csrc/dw_gemm.cuh``): plain Python, so the CPU tests check what the
kernels are handed.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from .. import kernels

# pointers, then T, B, H, row0, nrows, resident, then the stream
_SCAN_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                  + [ctypes.c_void_p])
_FWD_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                 + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                 + [ctypes.c_void_p])
# the three dW entry points: descriptors, their count, M, H, the tiling
# (tile width, operand rows a stage, ring stages), stream
_DW_ARGTYPES = ([ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 6
                + [ctypes.c_void_p])

#: shared memory one block may use on the card (227 KB)
SMEM_LIMIT = 232448


# ---------------------------------------------------------------------------
# host-side layouts of the persistent recurrences and the dW GEMM
# ---------------------------------------------------------------------------

#: csrc/lstm_persistent.cuh (lstm_scan and the training forward): hidden
#: units and batch rows a block owns, the reduction chunk of one stage of
#: its cp.async ring, and the ring depth beside a resident W_h slice /
#: with W_h streamed
SCAN_UNITS = 16
SCAN_ROWS = 64
SCAN_KC = 64
SCAN_STAGES = {True: 8, False: 4}
#: csrc/lstm_train.cu's backward: the same units and rows a block, a
#: 128-wide reduction chunk (over 4H) a stage, and its ring depth
BWD_KC = 128
BWD_STAGES = {True: 5, False: 4}


def scan_smem_bytes(h_dim: int, resident: bool) -> int:
    """Shared memory of one scan block: the W_h^T slice (4U rows of the
    reduction extent, padded by 8) when resident, the ring of h tiles
    (and of W tiles when streamed), and the f32 pre-activations."""
    ldk = SCAN_KC + 8
    extent = -(-h_dim // SCAN_KC) * SCAN_KC
    cols = 4 * SCAN_UNITS
    ring = (SCAN_STAGES[resident] * (SCAN_ROWS + (0 if resident else cols))
            * ldk * 2)
    w = cols * (extent + 8) * 2 if resident else 0
    return w + ring + SCAN_ROWS * (cols + 4) * 4


def scan_w_resident(h_dim: int) -> bool:
    """Whether a block's W_h slice stays in shared memory for all T (else
    the kernel streams it from L2 each step)."""
    return scan_smem_bytes(h_dim, True) <= SMEM_LIMIT


def bwd_smem_bytes(h_dim: int, resident: bool) -> int:
    """Shared memory of one backward block: the rows k0..k0+U of W_h (the
    4H reduction extent, padded by 8) when resident, and the ring of dzb
    tiles (and of W tiles when streamed), which also holds the warps'
    partial sums once drained."""
    ldk = BWD_KC + 8
    extent = -(-4 * h_dim // BWD_KC) * BWD_KC
    ring = (BWD_STAGES[resident]
            * (SCAN_ROWS + (0 if resident else SCAN_UNITS)) * ldk * 2)
    w = SCAN_UNITS * (extent + 8) * 2 if resident else 0
    return w + ring


def bwd_w_resident(h_dim: int) -> bool:
    """Whether a backward block's W_h rows stay in shared memory for all
    T (else the kernel streams them from L2 each reverse step)."""
    return bwd_smem_bytes(h_dim, True) <= SMEM_LIMIT


@dataclass(frozen=True)
class ScanPlan:
    """One call of a persistent recurrence kernel: its weight slice
    resident or streamed, each block's shared memory, the grid's blocks
    along H, and the row chunks of the batch, one cooperative launch each
    (``(row0, nrows)``; the grid of a launch is ``unit_blocks`` x
    ceil(nrows / rows)). A block owns ``units`` hidden units of ``rows``
    batch rows."""
    resident: bool
    smem_bytes: int
    unit_blocks: int
    launches: Tuple[Tuple[int, int], ...]
    units: int = SCAN_UNITS
    rows: int = SCAN_ROWS

    def grid(self, nrows: int) -> Tuple[int, int]:
        return self.unit_blocks, -(-nrows // self.rows)


def _row_chunks(name: str, h_dim: int, batch: int, max_blocks: int,
                resident: bool, smem: int, units: int = SCAN_UNITS,
                rows: int = SCAN_ROWS) -> ScanPlan:
    """Every block of a launch covers ``units`` units and ``rows`` rows;
    a batch that needs more row tiles than one grid of at most
    ``max_blocks`` co-resident blocks holds is cut into chunks."""
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: H={h_dim} needs {smem} bytes of shared "
                         f"memory a block")
    unit_blocks = -(-h_dim // units)
    tiles = max_blocks // unit_blocks
    if tiles < 1:
        raise ValueError(f"{name}: H={h_dim} needs {unit_blocks} "
                         f"co-resident blocks, the card holds {max_blocks}")
    chunk = tiles * rows
    launches = tuple((r0, min(chunk, batch - r0))
                     for r0 in range(0, batch, chunk))
    return ScanPlan(resident, smem, unit_blocks, launches, units, rows)


def lstm_scan_plan(h_dim: int, batch: int, max_blocks: int) -> ScanPlan:
    """Lay out ``lstm_scan`` -- and the training forward, which runs the
    same kernel code -- over a grid of at most ``max_blocks`` co-resident
    blocks (the card's count for this H and kernel). Each block owns all
    four gate columns of its units."""
    resident = scan_w_resident(h_dim)
    return _row_chunks("lstm_scan", h_dim, batch, max_blocks, resident,
                       scan_smem_bytes(h_dim, resident))


def lstm_train_bwd_plan(h_dim: int, batch: int, max_blocks: int) -> ScanPlan:
    """Lay out ``lstm_train_backward``'s reverse-time kernel over a grid of
    at most ``max_blocks`` co-resident blocks. Each block owns the dh, dc
    and the four dz columns of its units; its W_h rows stay in shared
    memory where they fit (H <= 1120)."""
    resident = bwd_w_resident(h_dim)
    return _row_chunks("lstm_train_backward", h_dim, batch, max_blocks,
                       resident, bwd_smem_bytes(h_dim, resident))


#: csrc/peephole_persistent.cuh (the peephole training forward) and the
#: peephole training backward (csrc/peephole_train.cu): hidden units and
#: batch rows a block owns (one mma n8 tile a gate, 16 rows a warp; half
#: the rows, at twice the blocks an SM, where the grid of streamed
#: 128-row blocks is not co-resident), and, with the weight slice
#: resident / streamed, the reduction chunk of one ring stage and the
#: ring depth
PEEP_UNITS = 8
PEEP_ROWS = 128
PEEP_NARROW_ROWS = 64
PEEP_KC = {True: 128, False: 64}
PEEP_STAGES = {True: 3, False: 4}


def _peep_extent(h_dim: int) -> int:
    """H rounded up to whole 128-wide chunks: a resident slice's row."""
    return -(-h_dim // PEEP_KC[True]) * PEEP_KC[True]


def _peep_ring(resident: bool, w_rows: int, rows: int) -> int:
    """The ring: the exchange tile of the block's rows, and the weight
    rows of the chunk beside it when the slice is streamed."""
    return (PEEP_STAGES[resident]
            * (rows + (0 if resident else w_rows))
            * (PEEP_KC[resident] + 8) * 2)


def peephole_fwd_smem_bytes(h_dim: int, resident: bool,
                            rows: int = PEEP_ROWS) -> int:
    """Shared memory of one training-forward block of ``rows`` batch rows:
    the 7U weight rows (W_h^T's four gates, P_o^T, P_i^T, P_f^T of its
    units, each padded by 8) when resident, and the ring (4U weight rows
    a stage streamed)."""
    w = 7 * PEEP_UNITS * (_peep_extent(h_dim) + 8) * 2 if resident else 0
    return w + _peep_ring(resident, 4 * PEEP_UNITS, rows)


def peephole_bwd_smem_bytes(h_dim: int, resident: bool,
                            rows: int = PEEP_ROWS) -> int:
    """Shared memory of one training-backward block of ``rows`` batch
    rows: per unit a dh row (row k of W_h, 4 gate blocks) and a dc row
    (row k of [P_i | P_f | P_o], 3 blocks), each block padded to whole
    chunks and each row by 8, when resident, and the ring (2U weight rows
    a stage streamed)."""
    w = (PEEP_UNITS * (7 * _peep_extent(h_dim) + 16) * 2 if resident
         else 0)
    return w + _peep_ring(resident, 2 * PEEP_UNITS, rows)


def _w_resident(smem_bytes, h_dim, units, rows, resident_blocks) -> bool:
    """Whether a block's weight slice stays in shared memory for all T: it
    fits, and the grid of the H/``units`` unit blocks of ``rows`` rows is
    co-resident at ``resident_blocks`` (one an SM, 132 on an H100). Else
    the kernel streams it from L2 each phase."""
    return (smem_bytes(h_dim, True, rows) <= SMEM_LIMIT
            and -(-h_dim // units) <= resident_blocks)


def peephole_bwd_w_resident(h_dim: int, resident_blocks: int) -> bool:
    """``_w_resident`` for the peephole training backward (H <= 1024
    with 128-wide chunks)."""
    return _w_resident(peephole_bwd_smem_bytes, h_dim, PEEP_UNITS,
                       PEEP_ROWS, resident_blocks)


def _persistent_plan(name, smem_bytes, h_dim, batch, capacity, units, rows,
                     narrow_rows) -> ScanPlan:
    """The weight slice resident where ``_w_resident`` says so at
    ``capacity(True, rows)``; else streamed, in blocks of ``narrow_rows``
    rows where the streamed ``rows``-row blocks of all units are not
    co-resident either."""
    resident = _w_resident(smem_bytes, h_dim, units, rows,
                           capacity(True, rows))
    if not resident and -(-h_dim // units) > capacity(False, rows):
        rows = narrow_rows
    return _row_chunks(name, h_dim, batch, capacity(resident, rows),
                       resident, smem_bytes(h_dim, resident, rows), units,
                       rows)


def _peep_plan(name, smem_bytes, h_dim, batch, capacity) -> ScanPlan:
    return _persistent_plan(name, smem_bytes, h_dim, batch, capacity,
                            PEEP_UNITS, PEEP_ROWS, PEEP_NARROW_ROWS)


def peephole_scan_plan(h_dim: int, batch: int,
                       capacity: Callable[[bool, int], int]) -> ScanPlan:
    """Lay out ``peephole_scan``'s persistent kernel, which runs the
    training forward's body without the residuals and the same layout as
    ``peephole_train_fwd_plan``; ``capacity`` is the scan kernel's."""
    return _peep_plan("peephole_scan", peephole_fwd_smem_bytes, h_dim,
                      batch, capacity)


def peephole_train_fwd_plan(
        h_dim: int, batch: int,
        capacity: Callable[[bool, int], int]) -> ScanPlan:
    """Lay out ``peephole_train_forward``'s persistent kernel.
    ``capacity(resident, rows)`` is the card's count of co-resident blocks
    with the weight slice resident or streamed and ``rows`` batch rows a
    block. Each block owns all four gate columns of its 8 units for 128
    batch rows, or 64 where the H/8 streamed blocks of 128 rows are not
    co-resident (H > 2112 on an H100)."""
    return _peep_plan("peephole_train_forward", peephole_fwd_smem_bytes,
                      h_dim, batch, capacity)


def peephole_train_bwd_plan(
        h_dim: int, batch: int,
        capacity: Callable[[bool, int], int]) -> ScanPlan:
    """Lay out ``peephole_train_backward``'s reverse-time kernel, as
    ``peephole_train_fwd_plan``. Each block owns the dh, dc and the four
    dz columns of its 8 units for the plan's batch rows."""
    return _peep_plan("peephole_train_backward", peephole_bwd_smem_bytes,
                      h_dim, batch, capacity)


#: csrc/gated_persistent.cuh (``gated_scan`` and the gated training
#: forward) and the gated training backward (csrc/gated_train.cu): hidden
#: units and batch rows a block owns (warps of 16 rows x 8 units, all gate
#: columns of them), and the rows a block takes where the grid of streamed
#: GATED_ROWS-row blocks is not co-resident; their ring is the peephole
#: kernels' (PEEP_KC, PEEP_STAGES). Read at call time, so that
#: bench_gated_layouts.py can lay out the 8- and 32-unit builds it times.
GATED_UNITS = 16
GATED_ROWS = 64
GATED_NARROW_ROWS = 32


def gated_fwd_smem_bytes(h_dim: int, resident: bool,
                         rows: int = GATED_ROWS) -> int:
    """Shared memory of one gated training-forward block of ``rows``
    batch rows: the weight slice, room for three gate groups of its
    units (w1^T's two, w2^T's; mgru fills two), each row padded by 8,
    when resident, and the ring (two groups' rows a stage streamed)."""
    w = 3 * GATED_UNITS * (_peep_extent(h_dim) + 8) * 2 if resident else 0
    return w + _peep_ring(resident, 2 * GATED_UNITS, rows)


def gated_bwd_smem_bytes(h_dim: int, resident: bool,
                         rows: int = GATED_ROWS) -> int:
    """Shared memory of one gated training-backward block of ``rows``
    batch rows: per unit k, row k of w1 as two groups (its pair columns
    [0, H) and [H, 2H)) and row k of w2, each padded by 8, when resident
    (the forward's three groups), and the ring (one group's rows a stage
    streamed)."""
    w = 3 * GATED_UNITS * (_peep_extent(h_dim) + 8) * 2 if resident else 0
    return w + _peep_ring(resident, GATED_UNITS, rows)


def _gated_plan(name, smem_bytes, h_dim, batch, capacity) -> ScanPlan:
    return _persistent_plan(name, smem_bytes, h_dim, batch, capacity,
                            GATED_UNITS, GATED_ROWS, GATED_NARROW_ROWS)


def gated_scan_plan(h_dim: int, batch: int,
                    capacity: Callable[[bool, int], int]) -> ScanPlan:
    """Lay out ``gated_scan``'s persistent kernel, which runs the training
    forward's body without the residuals and the same layout as
    ``gated_train_fwd_plan``; ``capacity`` is the scan kernel's."""
    return _gated_plan("gated_scan", gated_fwd_smem_bytes, h_dim, batch,
                       capacity)


def gated_train_fwd_plan(
        h_dim: int, batch: int,
        capacity: Callable[[bool, int], int]) -> ScanPlan:
    """Lay out ``gated_train_forward``'s persistent kernel, as
    ``peephole_train_fwd_plan`` does, for every kind alike: each block
    owns all gate columns of its 16 units for 64 batch rows, or 32 where
    the H/16 streamed blocks of 64 rows are not co-resident (H > 4224 on
    an H100; none above H = 8448); the slice stays resident up to
    H = 1792."""
    return _gated_plan("gated_train_forward", gated_fwd_smem_bytes, h_dim,
                       batch, capacity)


def gated_train_bwd_plan(
        h_dim: int, batch: int,
        capacity: Callable[[bool, int], int]) -> ScanPlan:
    """Lay out ``gated_train_backward``'s reverse-time kernel, as
    ``gated_train_fwd_plan``. Each block owns the dh, dzpre, dcpre and
    drpre columns of its 16 units for the plan's batch rows."""
    return _gated_plan("gated_train_backward", gated_bwd_smem_bytes, h_dim,
                       batch, capacity)


#: csrc/dw_gemm.cuh: the rows of dW a block owns, and the tilings it is
#: built for: (columns of dW a block owns, operand rows of one stage of
#: its ring, ring stages)
DW_TILE_M = 128
DW_CONFIGS = ((128, 64, 4), (256, 64, 3), (256, 64, 4))
#: wide tiles read 3/4 of the operand bytes of narrow ones for the same
#: work, so they are taken while they still give this many blocks (3/4 of
#: an H100's 132 SMs, one block an SM)
DW_WIDE_MIN_TILES = 96
DW_MAX_PROBLEMS = 4


@dataclass(frozen=True)
class DwProblem:
    """One contraction ``dW (H, n) = sum_m A[m]^T B[m]`` over the T*B rows:
    A is the residuals' columns ``[a_col, a_col + H)`` (row stride
    ``lda``) -- times ``[r_col, r_col + H)``, rounded to bf16, when
    ``r_col`` is set (the gated dW2) -- and B the columns ``[b_col, b_col
    + n)`` of operand ``b`` (row stride ``ldb``). Its output tiles start
    at flat tile ``tile0`` of the launch."""
    a_col: int
    r_col: Optional[int]
    lda: int
    b: str
    b_col: int
    ldb: int
    n: int
    tile0: int


@dataclass(frozen=True)
class DwPlan:
    """One dW launch: its problems, its tiling (``tile_n`` columns of dW
    a tile, ``rows`` operand rows a stage, a ``stages``-deep ring), the
    tiles (one block each) and each block's shared memory."""
    problems: Tuple[DwProblem, ...]
    tile_n: int
    rows: int
    stages: int
    tiles: int
    smem_bytes: int


def dw_tiles(h_dim: int, n: int, tile_n: int) -> int:
    return -(-h_dim // DW_TILE_M) * -(-n // tile_n)


def dw_smem_bytes(tile_n: int, rows: int, stages: int, has_r: bool) -> int:
    """The ring (A, r when set, B; bf16) and 1 KB to align it."""
    return (stages * rows * ((2 if has_r else 1) * DW_TILE_M + tile_n) * 2
            + 1024)


@functools.lru_cache(maxsize=None)
def dw_plan(family: str, h_dim: int, has_w2: bool = True,
            config: Optional[Tuple[int, int, int]] = None) -> DwPlan:
    """The problems of one dW launch: ``lstm`` (dW_h from h_{t-1} and dz),
    ``gated`` (dW1 from h_prev and pair; dW2 from bf16(r * h_prev) and dc
    when ``has_w2``) or ``peephole`` (dW_h, dP_i, dP_f, dP_o from h_{t-1},
    c_{t-1}, c_{t-1}, c_t and the four blocks of dz), in the order of the
    wrapper's outputs. The tiling: 256 columns a tile when that gives at
    least DW_WIDE_MIN_TILES tiles, else 128; 64 operand rows a stage; a
    4-deep ring, 3-deep when the gated r operand takes a third of it.
    ``config`` (tile_n, rows, stages), one of DW_CONFIGS, overrides it."""
    h = h_dim
    if family == "lstm":          # res [a | i | f | o | tanh c | c | h]
        specs = [(6 * h, None, 7 * h, "dz", 0, 4 * h, 4 * h)]
    elif family == "gated":       # res [r | z | hb | h_prev]
        specs = [(3 * h, None, 4 * h, "pair", 0, 2 * h, 2 * h)]
        if has_w2:
            specs.append((3 * h, 0, 4 * h, "dc", 0, h, h))
    elif family == "peephole":    # the LSTM's row and c_t
        specs = [(6 * h, None, 8 * h, "dz", 0, 4 * h, 4 * h),
                 (5 * h, None, 8 * h, "dz", h, 4 * h, h),
                 (5 * h, None, 8 * h, "dz", 2 * h, 4 * h, h),
                 (7 * h, None, 8 * h, "dz", 3 * h, 4 * h, h)]
    else:
        raise ValueError(f"dw_plan: unknown family {family!r}")
    has_r = any(r_col is not None for _, r_col, *_ in specs)
    if config is None:
        wide = sum(dw_tiles(h, n, 256) for *_, n in specs)
        config = ((256, 64, 3 if has_r else 4) if wide >= DW_WIDE_MIN_TILES
                  else (128, 64, 4))
    tile_n, rows, stages = config
    if (tile_n, rows, stages) not in DW_CONFIGS:
        raise ValueError(f"dw_plan: tiling {(tile_n, rows, stages)} is not "
                         f"one of {DW_CONFIGS}")
    problems, tile0 = [], 0
    for a_col, r_col, lda, b, b_col, ldb, n in specs:
        problems.append(DwProblem(a_col, r_col, lda, b, b_col, ldb, n, tile0))
        tile0 += dw_tiles(h, n, tile_n)
    return DwPlan(tuple(problems), tile_n, rows, stages, tile0,
                  dw_smem_bytes(tile_n, rows, stages, has_r))


def _dw_launch(name, fn, plan, h_dim, res, operands, outs, stream):
    """Launch one dW entry point on ``plan`` with the residuals ``res``
    (T, B, .), the B operands by name and the f32 outputs, in plan order:
    one grid for all problems."""
    base = res.data_ptr()
    words = []
    for p, out in zip(plan.problems, outs):
        words += [base + 2 * p.a_col, p.lda,
                  0 if p.r_col is None else base + 2 * p.r_col,
                  operands[p.b].data_ptr() + 2 * p.b_col, p.ldb,
                  out.data_ptr(), p.n, p.tile0]
    desc = (ctypes.c_longlong * len(words))(*words)
    m_rows = res.shape[0] * res.shape[1]
    kernels.check(fn(desc, len(plan.problems), m_rows, h_dim, plan.tile_n,
                     plan.rows, plan.stages, stream), name)
    kernels.launches[name] += 1


_CAPACITY: Dict[Tuple[str, int, int, bool], int] = {}


def _lib():
    lib = kernels.load("lstm_scan")
    for fn in (lib.lstm_scan_f32, lib.lstm_scan_bf16):
        fn.argtypes = _SCAN_ARGTYPES
        fn.restype = ctypes.c_int
    lib.lstm_scan_capacity.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int)]
    lib.lstm_scan_capacity.restype = ctypes.c_int
    return lib


def _capacity(name, query, device, h_dim, resident, *layout):
    """Co-resident blocks of the kernel ``name`` on ``device`` at this H,
    from its C query ``query(H, resident, *layout, &blocks)`` (``layout``:
    further int arguments of the query, e.g. the rows a block)."""
    key = (name, device.index, h_dim, resident, *layout)
    if key not in _CAPACITY:
        n = ctypes.c_int(0)
        with torch.cuda.device(device):
            kernels.check(query(h_dim, int(resident), *layout,
                                ctypes.byref(n)), name)
        _CAPACITY[key] = n.value
    return _CAPACITY[key]


def _train_lib():
    lib = kernels.load("lstm_train")
    for fns, argtypes in (((lib.lstm_train_fwd_f32, lib.lstm_train_fwd_bf16),
                           _FWD_ARGTYPES),
                          ((lib.lstm_train_bwd_f32, lib.lstm_train_bwd_bf16),
                           _BWD_ARGTYPES),
                          ((lib.lstm_train_dw,), _DW_ARGTYPES)):
        for fn in fns:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.lstm_train_capacity.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.lstm_train_capacity.restype = ctypes.c_int
    return lib


def _cell(z: torch.Tensor, c: torch.Tensor, h_dim: int):
    """Gates and carry update of one float32 step: a, i, f, o, c_t,
    tanh c_t, h_t."""
    a = torch.tanh(z[:, :h_dim])
    ig = torch.sigmoid(z[:, h_dim:2 * h_dim])
    f = torch.sigmoid(z[:, 2 * h_dim:3 * h_dim])
    o = torch.sigmoid(z[:, 3 * h_dim:])
    c_new = f * c + ig * a
    tc = torch.tanh(c_new)
    return a, ig, f, o, c_new, tc, o * tc


def _bf16f(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16, as float32."""
    return x.to(torch.bfloat16).float()


def _check_scan_args(name, proj, wh, c0, h0):
    t, b, g = proj.shape
    h_dim = wh.shape[0]
    if g != 4 * h_dim or wh.shape != (h_dim, g):
        raise ValueError(f"{name}: proj gate dim {g} / wh {tuple(wh.shape)} "
                         f"do not match 4*H")
    if c0.shape != (b, h_dim) or h0.shape != (b, h_dim):
        raise ValueError(f"{name}: c0/h0 must be (B, H)")
    if t < 1:
        raise ValueError(f"{name}: needs at least one timestep")


def _check_cuda(name, first, *others):
    """Raise unless ``first`` is a CUDA tensor and ``others`` lie on its
    device. Returns the kernel stream handle."""
    if first.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {first.device}")
    for i, x in enumerate(others):
        if x.device != first.device:
            raise ValueError(f"{name}: argument {i + 1} on {x.device}, "
                             f"argument 0 on {first.device}")
    return torch.cuda.current_stream(first.device).cuda_stream


def _dtype_suffix(name, dtype):
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.bfloat16:
        return "bf16"
    raise TypeError(f"{name}: dtype {dtype} not supported")


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------

def lstm_scan_reference(proj, wh, c0, h0):
    """Plain PyTorch version of the kernel, same contract.

    ``h`` and ``W_h`` are rounded to bf16 and multiplied in float32: a
    bf16 ``matmul`` would round its output to bf16 as well, which the
    kernel (f32 accumulation) does not.
    """
    h_dim = wh.shape[0]
    out_dtype = proj.dtype
    projf = _bf16f(proj)
    whf = _bf16f(wh)
    c = c0.float()
    h = h0.float()
    hs = torch.empty(proj.shape[:2] + (h_dim,), dtype=out_dtype,
                     device=proj.device)
    for t in range(proj.shape[0]):
        z = projf[t] + _bf16f(h) @ whf
        *_, c, _, h = _cell(z, c, h_dim)
        hs[t] = h.to(out_dtype)
    return (c.to(c0.dtype), h.to(c0.dtype)), hs


def lstm_scan(proj, wh, c0, h0):
    """Run the LSTM recurrence. proj (T, B, 4H), wh (H, 4H), c0/h0
    (B, H). Returns ``(c_T, h_T), hs`` with hs (T, B, H).

    CUDA tensors launch the kernel (or raise); CPU tensors take
    ``lstm_scan_reference``. On the card the whole sequence is one
    persistent launch per row chunk of ``lstm_scan_plan`` (one for
    B <= 128 at H=1024). The kernel has no backward: on the card a tensor
    that requires grad under grad mode raises, and training goes through
    ``lstm_scan_train``.
    """
    _check_scan_args("lstm_scan", proj, wh, c0, h0)
    if proj.device.type == "cpu":
        return lstm_scan_reference(proj, wh, c0, h0)
    stream = _check_cuda("lstm_scan", proj, wh, c0, h0)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (proj, wh, c0, h0)):
        raise RuntimeError(
            "lstm_scan: the inference kernel has no backward, and its "
            "outputs would carry no gradient; train through "
            "lstm_scan_train, or run under torch.no_grad() / "
            "torch.inference_mode()")
    lib = _lib()
    fn = getattr(lib, "lstm_scan_" + _dtype_suffix("lstm_scan", proj.dtype))
    hs, c, h = _persistent_recurrence(
        "lstm_scan", fn, lib.lstm_scan_capacity, proj, wh, c0, h0, stream)
    return (c.to(c0.dtype), h.to(c0.dtype)), hs


def _persistent_recurrence(name, fn, query, proj, wh, c0, h0, stream,
                           res=None):
    """Run the persistent recurrence kernel ``fn`` (``lstm_scan``'s, or the
    training forward's, which also writes ``res``) in the row chunks of
    ``lstm_scan_plan`` for its co-residency ``query``. Returns ``hs`` and
    the float32 carries ``c_T``, ``h_T``."""
    if not proj.is_contiguous():
        raise ValueError(f"{name}: proj must be contiguous")
    t, b, _ = proj.shape
    h_dim = wh.shape[0]
    dev = proj.device
    plan = lstm_scan_plan(h_dim, b, _capacity(name, query, dev, h_dim,
                                              scan_w_resident(h_dim)))
    wt = wh.detach().to(torch.bfloat16).t().contiguous()   # W_h^T (4H, H)
    h = h0.detach().float().contiguous().clone()
    c = c0.detach().float().contiguous().clone()
    hx = torch.empty((2, b, h_dim), dtype=torch.bfloat16, device=dev)
    hs = torch.empty((t, b, h_dim), dtype=proj.dtype, device=dev)
    bar = torch.zeros(len(plan.launches), dtype=torch.int32, device=dev)
    ptrs = [x.data_ptr() for x in (proj, wt, h, c, hx, hs)
            + (() if res is None else (res,))]
    for i, (row0, nrows) in enumerate(plan.launches):
        kernels.check(fn(*ptrs, bar.data_ptr() + 4 * i, t, b, h_dim, row0,
                         nrows, int(plan.resident), stream), name)
    kernels.launches[name] += 1
    return hs, c, h


# ---------------------------------------------------------------------------
# training: forward with residuals
# ---------------------------------------------------------------------------

def lstm_train_forward_reference(proj, wh, c0, h0):
    """Plain version of ``lstm_train_forward``: the step loop of
    ``_lstm_train_fwd_impl`` (rnn_pallas.py:417-441) with its bf16
    roundings. Returns ``hs, res, c_T, h_T`` (carries in float32)."""
    h_dim = wh.shape[0]
    t_len, b = proj.shape[:2]
    projf = _bf16f(proj)
    whf = _bf16f(wh)
    c = c0.float()
    h = h0.float()
    hs = torch.empty((t_len, b, h_dim), dtype=proj.dtype, device=proj.device)
    res = torch.empty((t_len, b, 7 * h_dim), dtype=torch.bfloat16,
                      device=proj.device)
    for t in range(t_len):
        z = projf[t] + _bf16f(h) @ whf
        a, ig, f, o, c_new, tc, h_new = _cell(z, c, h_dim)
        res[t] = torch.cat([a, ig, f, o, tc, c, h], dim=1).to(torch.bfloat16)
        c, h = c_new, h_new
        hs[t] = h.to(proj.dtype)
    return hs, res, c, h


def lstm_train_forward(proj, wh, c0, h0):
    """Forward of the trainable recurrence. proj (T, B, 4H), wh (H, 4H),
    c0/h0 (B, H). Returns ``hs`` (T, B, H) in proj's dtype, the
    residuals ``res`` (T, B, 7H) bf16, and ``c_T``, ``h_T`` float32.

    On the card: one persistent launch per row chunk of
    ``lstm_scan_plan``, running ``lstm_scan``'s kernel code plus the
    residual stores, so hs, c_T and h_T are bit-equal to ``lstm_scan``'s.
    """
    _check_scan_args("lstm_train_forward", proj, wh, c0, h0)
    if proj.device.type == "cpu":
        return lstm_train_forward_reference(proj, wh, c0, h0)
    stream = _check_cuda("lstm_train_forward", proj, wh, c0, h0)
    lib = _train_lib()
    fn = getattr(lib, "lstm_train_fwd_" + _dtype_suffix(
        "lstm_train_forward", proj.dtype))
    t, b, _ = proj.shape
    res = torch.empty((t, b, 7 * wh.shape[0]), dtype=torch.bfloat16,
                      device=proj.device)
    query = functools.partial(lib.lstm_train_capacity, 0)   # the forward
    hs, c, h = _persistent_recurrence("lstm_train_forward", fn, query, proj,
                                      wh, c0, h0, stream, res)
    return hs, res, c, h


# ---------------------------------------------------------------------------
# training: reverse-time backward and the dW contraction
# ---------------------------------------------------------------------------

def lstm_train_dw_reference(res, dz):
    """Plain version of ``lstm_train_dw``: float32 product of the
    bf16 ``h_{t-1}`` rows of ``res`` and the bf16 ``dz`` rows."""
    h_dim = res.shape[-1] // 7
    hp = res[..., 6 * h_dim:].reshape(-1, h_dim).float()
    return hp.T @ dz.reshape(-1, 4 * h_dim).float()


def lstm_train_dw(res, dz):
    """``dW_h = sum_t bf16(h_{t-1})^T bf16(dz_t)`` in float32 from the
    residuals res (T, B, 7H) bf16 and dz (T, B, 4H) bf16 -> (H, 4H)."""
    t, b, seven_h = res.shape
    h_dim = seven_h // 7
    if (seven_h != 7 * h_dim or dz.shape != (t, b, 4 * h_dim)
            or res.dtype != torch.bfloat16 or dz.dtype != torch.bfloat16):
        raise ValueError("lstm_train_dw: res (T, B, 7H) and dz (T, B, 4H) "
                         "must be bf16")
    if res.device.type == "cpu":
        return lstm_train_dw_reference(res, dz)
    stream = _check_cuda("lstm_train_dw", res, dz)
    if not (res.is_contiguous() and dz.is_contiguous()):
        raise ValueError("lstm_train_dw: res and dz must be contiguous")
    dw = torch.empty((h_dim, 4 * h_dim), dtype=torch.float32,
                     device=res.device)
    _dw_launch("lstm_train_dw", _train_lib().lstm_train_dw,
               dw_plan("lstm", h_dim), h_dim, res, {"dz": dz}, [dw], stream)
    return dw


def lstm_train_backward_reference(res, wh, dhs, dc_T, dh_T, proj_dtype):
    """Plain version of ``lstm_train_backward``: the reverse step loop
    of ``_lstm_train_bwd_impl`` (rnn_pallas.py:532-580) with its bf16
    roundings, then ``lstm_train_dw_reference``."""
    t_len, b, seven_h = res.shape
    h_dim = seven_h // 7
    whf = _bf16f(wh)
    dc = dc_T.float()
    dh = dh_T.float()
    dproj = torch.empty((t_len, b, 4 * h_dim), dtype=proj_dtype,
                        device=res.device)
    dzb = torch.empty((t_len, b, 4 * h_dim), dtype=torch.bfloat16,
                      device=res.device)
    for t in range(t_len - 1, -1, -1):
        a, ig, f, o, tc, c_prev = res[t, :, :6 * h_dim].float().split(
            h_dim, dim=1)
        dh_tot = dhs[t].float() + dh
        do = dh_tot * tc
        dc = dc + dh_tot * o * (1.0 - tc * tc)
        da = dc * ig
        dig = dc * a
        df = dc * c_prev
        dc_prev = dc * f
        dz = torch.cat([da * (1.0 - a * a), dig * ig * (1.0 - ig),
                        df * f * (1.0 - f), do * o * (1.0 - o)], dim=1)
        dproj[t] = dz.to(proj_dtype)
        dzb[t] = dz.to(torch.bfloat16)
        dh = dzb[t].float() @ whf.T
        dc = dc_prev
    dwh = lstm_train_dw_reference(res, dzb).to(wh.dtype)
    return dproj, dwh, dc, dh


def lstm_train_backward(res, wh, dhs, dc_T, dh_T, proj_dtype):
    """Backward of the trainable recurrence from its residuals.

    res (T, B, 7H) bf16, wh (H, 4H), dhs (T, B, H), dc_T/dh_T (B, H).
    Returns ``dproj`` (T, B, 4H) in ``proj_dtype``, ``dW_h`` (H, 4H) in
    wh's dtype, and ``dc0``, ``dh0`` float32.

    On the card: one persistent launch over all reverse steps per row
    chunk of ``lstm_train_bwd_plan``, then one dW launch
    (``lstm_train_dw``) on the bf16 dz it leaves behind.
    """
    t, b, seven_h = res.shape
    h_dim = seven_h // 7
    if (seven_h != 7 * h_dim or wh.shape != (h_dim, 4 * h_dim)
            or dhs.shape != (t, b, h_dim) or dc_T.shape != (b, h_dim)
            or dh_T.shape != (b, h_dim) or res.dtype != torch.bfloat16):
        raise ValueError("lstm_train_backward: shapes do not match "
                         "res (T, B, 7H) bf16")
    if t < 1:
        raise ValueError("lstm_train_backward: needs at least one timestep")
    if res.device.type == "cpu":
        return lstm_train_backward_reference(res, wh, dhs, dc_T, dh_T,
                                             proj_dtype)
    stream = _check_cuda("lstm_train_backward", res, wh, dhs, dc_T, dh_T)
    lib = _train_lib()
    fn = getattr(lib, "lstm_train_bwd_" + _dtype_suffix(
        "lstm_train_backward", proj_dtype))
    if not res.is_contiguous():
        raise ValueError("lstm_train_backward: res must be contiguous")
    dev = res.device
    plan = lstm_train_bwd_plan(h_dim, b, _capacity(
        "lstm_train_backward", functools.partial(lib.lstm_train_capacity, 1),
        dev, h_dim, bwd_w_resident(h_dim)))
    whb = wh.detach().to(torch.bfloat16).contiguous()
    dhs_f = dhs.float().contiguous()
    dh_t = dh_T.float().contiguous()
    dc = dc_T.float().contiguous().clone()
    dproj = torch.empty((t, b, 4 * h_dim), dtype=proj_dtype, device=dev)
    dz = torch.empty((t, b, 4 * h_dim), dtype=torch.bfloat16, device=dev)
    dh0 = torch.empty((b, h_dim), dtype=torch.float32, device=dev)
    bar = torch.zeros(len(plan.launches), dtype=torch.int32, device=dev)
    for i, (row0, nrows) in enumerate(plan.launches):
        kernels.check(fn(res.data_ptr(), whb.data_ptr(), dhs_f.data_ptr(),
                         dh_t.data_ptr(), dc.data_ptr(), dproj.data_ptr(),
                         dz.data_ptr(), dh0.data_ptr(),
                         bar.data_ptr() + 4 * i, t, b, h_dim, row0, nrows,
                         int(plan.resident), stream),
                      "lstm_train_backward")
    kernels.launches["lstm_train_backward"] += 1
    dwh = lstm_train_dw(res, dz).to(wh.dtype)
    return dproj, dwh, dc, dh0


class _LSTMScanTrain(torch.autograd.Function):
    """Custom backward of the recurrence: the twin of the JAX
    ``lstm_scan_pallas_train`` custom VJP (rnn_pallas.py:627-667).
    ``lstm_train_forward`` / ``lstm_train_backward`` are looked up at
    call time, so a caller can swap in the plain versions."""

    @staticmethod
    def forward(ctx, proj, wh, c0, h0):
        hs, res, c_t, h_t = lstm_train_forward(proj, wh, c0, h0)
        ctx.save_for_backward(res, wh)
        ctx.proj_dtype = proj.dtype
        # TBPTT reads no c_T / h_T cotangent: they arrive as zeros
        ctx.set_materialize_grads(True)
        return c_t.to(c0.dtype), h_t.to(c0.dtype), hs

    @staticmethod
    def backward(ctx, dc_t, dh_t, dhs):
        res, wh = ctx.saved_tensors
        dproj, dwh, dc0, dh0 = lstm_train_backward(res, wh, dhs, dc_t, dh_t,
                                                   ctx.proj_dtype)
        return dproj, dwh, dc0.to(dc_t.dtype), dh0.to(dh_t.dtype)


def lstm_scan_train(proj, wh, c0, h0):
    """Differentiable LSTM recurrence for training, same signature and
    forward values as ``lstm_scan``: ``(c_T, h_T), hs``. Gradients come
    from the reverse-time kernel (``lstm_train_backward``) with bf16
    residuals, as from the JAX custom VJP."""
    c_t, h_t, hs = _LSTMScanTrain.apply(proj, wh, c0, h0)
    return (c_t, h_t), hs


# ---------------------------------------------------------------------------
# gated recurrences (GRU, minimal GRU with and without the reset gate)
# ---------------------------------------------------------------------------

#: kind -> (kernel code, gates packed in proj)
_GATED_KINDS = {"gru": (0, 3), "mgru_r": (1, 3), "mgru": (2, 2)}
#: the candidate nonlinearities by name (the JAX ``networks.ACTIVATIONS``)
ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
               "tanh": torch.tanh}
_ACT_CODES = {"tanh": 0, "relu": 1, "sigmoid": 2}

# the scan (8 pointers), the training forward (9) and backward (10):
# pointers, then T, B, H, row0, nrows, kind, act, resident, rows a block,
# then the stream
_GATED_SCAN_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                        + [ctypes.c_void_p])
_GATED_FWD_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
_GATED_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])


def _gated_scan_lib():
    lib = kernels.load("gated_scan")
    for fn in (lib.gated_scan_f32, lib.gated_scan_bf16):
        fn.argtypes = _GATED_SCAN_ARGTYPES
        fn.restype = ctypes.c_int
    lib.gated_scan_capacity.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.gated_scan_capacity.restype = ctypes.c_int
    return lib


def _gated_train_lib():
    lib = kernels.load("gated_train")
    for fns, argtypes in (((lib.gated_train_fwd_f32, lib.gated_train_fwd_bf16),
                           _GATED_FWD_ARGTYPES),
                          ((lib.gated_train_bwd_f32, lib.gated_train_bwd_bf16),
                           _GATED_BWD_ARGTYPES),
                          ((lib.gated_train_dw,), _DW_ARGTYPES)):
        for fn in fns:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.gated_train_capacity.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.gated_train_capacity.restype = ctypes.c_int
    return lib


def _ptr(x):
    return None if x is None else x.data_ptr()


def _gated_act(kind, activation):
    """The candidate's activation name: always tanh for ``gru``, the
    given one for the ``mgru`` kinds."""
    if kind not in _GATED_KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    act = "tanh" if kind == "gru" else activation
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")
    return act


def _check_gated_args(name, proj, w1, w2, h0, kind):
    if kind not in _GATED_KINDS:
        raise ValueError(f"{name}: unknown kind {kind!r}")
    t, b, g = proj.shape
    h_dim = w1.shape[0]
    gp = _GATED_KINDS[kind][1]
    if g != gp * h_dim or w1.shape != (h_dim, 2 * h_dim):
        raise ValueError(f"{name}: proj gate dim {g} / w1 {tuple(w1.shape)} "
                         f"do not match {gp}*H / (H, 2H) for kind {kind!r}")
    if (w2 is None) != (kind == "mgru") or (
            w2 is not None and w2.shape != (h_dim, h_dim)):
        raise ValueError(f"{name}: kind {kind!r} takes "
                         + ("no w2" if kind == "mgru" else "w2 (H, H)"))
    if h0.shape != (b, h_dim):
        raise ValueError(f"{name}: h0 must be (B, H)")
    if t < 1:
        raise ValueError(f"{name}: needs at least one timestep")


def _gated_step(kind, act, p, m1, h, mm2):
    """One float32 step (rnn_pallas.py:250-264): r, z, hb and h' from the
    proj row ``p``, ``m1 = h @ w1`` and ``mm2(x) = x @ w2``."""
    h_dim = h.shape[1]
    act_fn = ACTIVATIONS[act]
    if kind == "gru":
        r = torch.sigmoid(p[:, :h_dim] + m1[:, :h_dim])
        z = torch.sigmoid(p[:, h_dim:2 * h_dim] + m1[:, h_dim:])
        hb = act_fn(p[:, 2 * h_dim:] + mm2(r * h))
    elif kind == "mgru_r":
        z = torch.sigmoid(p[:, :h_dim] + m1[:, :h_dim])
        r = torch.sigmoid(p[:, 2 * h_dim:] + m1[:, h_dim:])
        hb = act_fn(p[:, h_dim:2 * h_dim] + mm2(r * h))
    else:
        z = torch.sigmoid(p[:, :h_dim] + m1[:, :h_dim])
        r = torch.zeros_like(z)
        hb = act_fn(p[:, h_dim:2 * h_dim] + m1[:, h_dim:])
    return r, z, hb, z * hb + (1.0 - z) * h


def _gated_forward_loop(proj, w1, w2, h0, kind, act, with_res):
    """The plain step loop of the forward kernels with their bf16
    roundings. Returns ``hs, res (or None), h_T`` (h_T float32)."""
    h_dim = w1.shape[0]
    t_len, b = proj.shape[:2]
    projf = _bf16f(proj)
    w1f = _bf16f(w1)
    w2f = None if w2 is None else _bf16f(w2)

    def mm2(x):
        return _bf16f(x) @ w2f

    h = h0.float()
    hs = torch.empty((t_len, b, h_dim), dtype=proj.dtype, device=proj.device)
    res = (torch.empty((t_len, b, 4 * h_dim), dtype=torch.bfloat16,
                       device=proj.device) if with_res else None)
    for t in range(t_len):
        r, z, hb, h_new = _gated_step(kind, act, projf[t], _bf16f(h) @ w1f,
                                      h, mm2)
        if with_res:
            res[t] = torch.cat([r, z, hb, h], dim=1).to(torch.bfloat16)
        h = h_new
        hs[t] = h.to(proj.dtype)
    return hs, res, h


def gated_scan_reference(proj, w1, w2, h0, *, kind, activation="tanh"):
    """Plain PyTorch version of ``gated_scan``, same contract: the twin
    of ``gated_scan_mixed_reference`` (rnn_pallas.py:320-353), the
    operands rounded to bf16 and multiplied in float32."""
    act = _gated_act(kind, activation)
    hs, _, h = _gated_forward_loop(proj, w1, w2, h0, kind, act, False)
    return h.to(h0.dtype), hs


def gated_scan(proj, w1, w2, h0, *, kind, activation="tanh"):
    """Run a gated recurrence (``kind`` "gru", "mgru_r" or "mgru").

    proj (T, B, gp*H) packed as ``rnn_pallas.py:211-216`` says (gp = 3,
    or 2 for ``mgru``), w1 (H, 2H), w2 (H, H) or None for ``mgru``, h0
    (B, H); ``activation`` names the ``mgru`` kinds' candidate
    nonlinearity ("tanh", "relu", "sigmoid"; ``gru`` is always tanh).
    Returns ``h_T, hs`` with hs (T, B, H) in proj's dtype and h_T in
    h0's.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    ``gated_scan_reference``. On the card the whole sequence is one
    persistent launch per row chunk of ``gated_scan_plan`` (one for
    B <= 128 at H=1024; H <= 8448 on an H100), the training forward's
    kernel body without the residuals: hs and h_T are bit-equal to
    ``gated_train_forward``'s. The kernel has no backward: on the card a
    tensor that requires grad under grad mode raises, and training goes
    through ``gated_scan_train``.
    """
    name = "gated_scan"
    _check_gated_args(name, proj, w1, w2, h0, kind)
    act = _gated_act(kind, activation)
    if proj.device.type == "cpu":
        return gated_scan_reference(proj, w1, w2, h0, kind=kind,
                                    activation=act)
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (proj, w1, w2, h0)):
        raise RuntimeError(
            "gated_scan: the inference kernel has no backward, and its "
            "outputs would carry no gradient; train through "
            "gated_scan_train, or run under torch.no_grad() / "
            "torch.inference_mode()")
    stream = _check_cuda(name, proj, w1, h0, *([] if w2 is None else [w2]))
    if not proj.is_contiguous():
        raise ValueError(f"{name}: proj must be contiguous")
    lib = _gated_scan_lib()
    fn = getattr(lib, "gated_scan_" + _dtype_suffix(name, proj.dtype))
    hs, _, h_t = _gated_forward_launch(name, gated_scan_plan, fn,
                                       lib.gated_scan_capacity, proj, w1, w2,
                                       h0, kind, act, stream, with_res=False)
    return h_t.to(h0.dtype), hs


def gated_train_forward_reference(proj, w1, w2, h0, *, kind,
                                  activation="tanh"):
    """Plain version of ``gated_train_forward``: the step loop of
    ``_gated_train_fwd_impl`` (rnn_pallas.py:722-747) with its bf16
    roundings. Returns ``hs, res, h_T`` (h_T float32)."""
    act = _gated_act(kind, activation)
    return _gated_forward_loop(proj, w1, w2, h0, kind, act, True)


def gated_train_forward(proj, w1, w2, h0, *, kind, activation="tanh"):
    """Forward of the trainable gated recurrence, ``gated_scan``'s
    arguments. Returns ``hs`` (T, B, H) in proj's dtype, the residuals
    ``res`` (T, B, 4H) bf16 ``[r | z | hb | h_prev]`` (r = 0 for
    ``mgru``), and ``h_T`` float32.

    On the card: one persistent launch per row chunk of
    ``gated_train_fwd_plan`` (one for B <= 128 at H=1024), two grid
    exchanges a step for gru and mgru_r and one for mgru, tensor-core
    sums. ``gated_scan`` runs the same kernel body, so hs and h_T are
    bit-equal to its; a second call gives the same bits.
    """
    name = "gated_train_forward"
    _check_gated_args(name, proj, w1, w2, h0, kind)
    act = _gated_act(kind, activation)
    if proj.device.type == "cpu":
        return gated_train_forward_reference(proj, w1, w2, h0, kind=kind,
                                             activation=act)
    stream = _check_cuda(name, proj, w1, h0, *([] if w2 is None else [w2]))
    if not proj.is_contiguous():
        raise ValueError(f"{name}: proj must be contiguous")
    lib = _gated_train_lib()
    fn = getattr(lib, "gated_train_fwd_" + _dtype_suffix(name, proj.dtype))
    return _gated_train_forward_launch(
        fn, functools.partial(lib.gated_train_capacity, 0), proj, w1, w2, h0,
        kind, act, stream)


def _gated_train_forward_launch(fn, query, proj, w1, w2, h0, kind, act,
                                stream):
    """The training forward's entry point ``fn`` in
    ``gated_train_fwd_plan``'s row chunks. Returns ``hs, res, h_T``."""
    return _gated_forward_launch("gated_train_forward", gated_train_fwd_plan,
                                 fn, query, proj, w1, w2, h0, kind, act,
                                 stream, with_res=True)


def _gated_forward_launch(name, plan_fn, fn, query, proj, w1, w2, h0, kind,
                          act, stream, with_res):
    """The operands, scratch and outputs of a persistent gated forward's
    entry point ``fn`` (the scan's, or with ``with_res`` the training
    forward's), launched in ``plan_fn``'s row chunks. Returns ``hs, res
    (None without with_res), h_T``."""
    t, b, _ = proj.shape
    h_dim = w1.shape[0]
    dev = proj.device
    w1t = w1.detach().to(torch.bfloat16).t().contiguous()   # w1^T (2H, H)
    w2t = (None if w2 is None
           else w2.detach().to(torch.bfloat16).t().contiguous())
    h = h0.detach().float().contiguous().clone()
    hx = torch.empty((2, b, h_dim), dtype=torch.bfloat16, device=dev)
    rx = (None if w2 is None
          else torch.empty((b, h_dim), dtype=torch.bfloat16, device=dev))
    hs = torch.empty((t, b, h_dim), dtype=proj.dtype, device=dev)
    res = (torch.empty((t, b, 4 * h_dim), dtype=torch.bfloat16, device=dev)
           if with_res else None)
    _cooperative_launches(name, plan_fn, fn, query, dev, h_dim, b,
                          (proj, w1t, w2t, h, hx, rx, hs)
                          + ((res,) if with_res else ()), t, stream,
                          (_GATED_KINDS[kind][0], _ACT_CODES[act]))
    return hs, res, h


def gated_train_dw_reference(res, pair, dc):
    """Plain version of ``gated_train_dw``: float32 products of the bf16
    ``h_prev`` rows of ``res`` with the bf16 pair rows, and of
    ``bf16(r * h_prev)`` with the bf16 ``dcpre`` rows."""
    h_dim = res.shape[-1] // 4
    hp = res[..., 3 * h_dim:].reshape(-1, h_dim).float()
    dw1 = hp.T @ pair.reshape(-1, 2 * h_dim).float()
    if dc is None:
        return dw1, None
    rh = _bf16f(res[..., :h_dim].float() * res[..., 3 * h_dim:].float())
    return dw1, rh.reshape(-1, h_dim).T @ dc.reshape(-1, h_dim).float()


def gated_train_dw(res, pair, dc):
    """``dW1 = sum_t h_prev^T bf16(pair)`` and, when ``dc`` is given,
    ``dW2 = sum_t bf16(r * h_prev)^T bf16(dcpre)``, in float32, from the
    residuals res (T, B, 4H), pair (T, B, 2H) and dc (T, B, H), all
    bf16 -> ``(dW1 (H, 2H), dW2 (H, H) or None)``."""
    t, b, four_h = res.shape
    h_dim = four_h // 4
    if (four_h != 4 * h_dim or pair.shape != (t, b, 2 * h_dim)
            or (dc is not None and dc.shape != (t, b, h_dim))
            or any(x is not None and x.dtype != torch.bfloat16
                   for x in (res, pair, dc))):
        raise ValueError("gated_train_dw: res (T, B, 4H), pair (T, B, 2H) "
                         "and dc (T, B, H) must be bf16")
    if res.device.type == "cpu":
        return gated_train_dw_reference(res, pair, dc)
    stream = _check_cuda("gated_train_dw", res, pair,
                         *([] if dc is None else [dc]))
    if not all(x is None or x.is_contiguous() for x in (res, pair, dc)):
        raise ValueError("gated_train_dw: res, pair and dc must be "
                         "contiguous")
    dw1 = torch.empty((h_dim, 2 * h_dim), dtype=torch.float32,
                      device=res.device)
    dw2 = (None if dc is None else
           torch.empty((h_dim, h_dim), dtype=torch.float32,
                       device=res.device))
    _dw_launch("gated_train_dw", _gated_train_lib().gated_train_dw,
               dw_plan("gated", h_dim, has_w2=dc is not None), h_dim, res,
               {"pair": pair, "dc": dc}, [dw1, dw2], stream)
    return dw1, dw2


def _act_grad(act, hb):
    """d activation / d pre-activation through the output ``hb``
    (rnn_pallas.py:673-681)."""
    if act == "tanh":
        return 1.0 - hb * hb
    if act == "relu":
        return (hb > 0.0).float()
    return hb * (1.0 - hb)


def _check_gated_bwd_args(name, res, w1, w2, dhs, dh_T, kind):
    if kind not in _GATED_KINDS:
        raise ValueError(f"{name}: unknown kind {kind!r}")
    t, b, four_h = res.shape
    h_dim = four_h // 4
    if (four_h != 4 * h_dim or w1.shape != (h_dim, 2 * h_dim)
            or (w2 is None) != (kind == "mgru")
            or (w2 is not None and w2.shape != (h_dim, h_dim))
            or dhs.shape != (t, b, h_dim) or dh_T.shape != (b, h_dim)
            or res.dtype != torch.bfloat16):
        raise ValueError(f"{name}: shapes do not match res (T, B, 4H) bf16 "
                         f"for kind {kind!r}")
    if t < 1:
        raise ValueError(f"{name}: needs at least one timestep")


def gated_train_backward_reference(res, w1, w2, dhs, dh_T, proj_dtype, *,
                                   kind, activation="tanh"):
    """Plain version of ``gated_train_backward``: the reverse step loop
    of ``_gated_train_bwd_impl`` (rnn_pallas.py:824-881) with its bf16
    roundings, then ``gated_train_dw_reference``."""
    act = _gated_act(kind, activation)
    t_len, b, four_h = res.shape
    h_dim = four_h // 4
    gp = _GATED_KINDS[kind][1]
    has_w2 = w2 is not None
    w1f = _bf16f(w1)
    w2f = _bf16f(w2) if has_w2 else None
    dh = dh_T.float()
    dproj = torch.empty((t_len, b, gp * h_dim), dtype=proj_dtype,
                        device=res.device)
    pair = torch.empty((t_len, b, 2 * h_dim), dtype=torch.bfloat16,
                       device=res.device)
    dc = (torch.empty((t_len, b, h_dim), dtype=torch.bfloat16,
                      device=res.device) if has_w2 else None)
    for t in range(t_len - 1, -1, -1):
        r, z, hb, h_prev = res[t].float().split(h_dim, dim=1)
        dh_tot = dhs[t].float() + dh
        dz = dh_tot * (hb - h_prev)
        dhb = dh_tot * z
        dh_new = dh_tot * (1.0 - z)
        dzpre = dz * z * (1.0 - z)
        dcpre = dhb * _act_grad(act, hb)
        if has_w2:
            dc[t] = dcpre.to(torch.bfloat16)
            drh = dc[t].float() @ w2f.T
            dr = drh * h_prev
            dh_new = dh_new + drh * r
            drpre = dr * r * (1.0 - r)
        if kind == "gru":            # proj [r, z, c], w1 [r | z]
            cols, pa, pb = (drpre, dzpre, dcpre), drpre, dzpre
        elif kind == "mgru_r":       # proj [z, c, r], w1 [z | r]
            cols, pa, pb = (dzpre, dcpre, drpre), dzpre, drpre
        else:                        # proj [z, c], w1 [z | c]
            cols, pa, pb = (dzpre, dcpre), dzpre, dcpre
        dproj[t] = torch.cat(cols, dim=1).to(proj_dtype)
        pair[t] = torch.cat([pa, pb], dim=1).to(torch.bfloat16)
        dh = dh_new + pair[t].float() @ w1f.T
    dw1, dw2 = gated_train_dw_reference(res, pair, dc)
    return (dproj, dw1.to(w1.dtype), None if dw2 is None else dw2.to(w2.dtype),
            dh)


def gated_train_backward(res, w1, w2, dhs, dh_T, proj_dtype, *, kind,
                         activation="tanh"):
    """Backward of the trainable gated recurrence from its residuals.

    res (T, B, 4H) bf16, w1 (H, 2H), w2 (H, H) or None for ``mgru``,
    dhs (T, B, H), dh_T (B, H). Returns ``dproj`` (T, B, gp*H) in
    ``proj_dtype`` and proj's packing order, ``dW1`` in w1's dtype,
    ``dW2`` in w2's (None for ``mgru``) and ``dh0`` float32.

    On the card: one persistent launch over all reverse steps per row
    chunk of ``gated_train_bwd_plan`` (one for B <= 128 at H=1024), two
    grid exchanges a reverse step for gru and mgru_r and one for mgru,
    tensor-core sums, a second call gives the same bits; then one dW
    launch (``gated_train_dw``) on the bf16 pair and dcpre it leaves
    behind.
    """
    name = "gated_train_backward"
    _check_gated_bwd_args(name, res, w1, w2, dhs, dh_T, kind)
    act = _gated_act(kind, activation)
    if res.device.type == "cpu":
        return gated_train_backward_reference(res, w1, w2, dhs, dh_T,
                                              proj_dtype, kind=kind,
                                              activation=act)
    stream = _check_cuda(name, res, w1, dhs, dh_T,
                         *([] if w2 is None else [w2]))
    lib = _gated_train_lib()
    fn = getattr(lib, "gated_train_bwd_" + _dtype_suffix(name, proj_dtype))
    if not res.is_contiguous():
        raise ValueError(f"{name}: res must be contiguous")
    dproj, pair, dc, dh0 = _gated_train_backward_launch(
        fn, functools.partial(lib.gated_train_capacity, 1), res, w1, w2, dhs,
        dh_T, proj_dtype, kind, act, stream)
    dw1, dw2 = gated_train_dw(res, pair, dc)
    return (dproj, dw1.to(w1.dtype), None if dw2 is None else dw2.to(w2.dtype),
            dh0)


def _gated_train_backward_launch(fn, query, res, w1, w2, dhs, dh_T,
                                 proj_dtype, kind, act, stream):
    """The operands, scratch and outputs of the training backward's entry
    point ``fn``, launched in ``gated_train_bwd_plan``'s row chunks.
    Returns ``dproj``, the bf16 ``pair`` and ``dc`` (None for ``mgru``) it
    leaves for the dW contractions, and ``dh0``."""
    t, b, four_h = res.shape
    h_dim = four_h // 4
    dev = res.device
    w2b = None if w2 is None else _bf16c(w2)
    dproj = torch.empty((t, b, _GATED_KINDS[kind][1] * h_dim),
                        dtype=proj_dtype, device=dev)
    pair = torch.empty((t, b, 2 * h_dim), dtype=torch.bfloat16, device=dev)
    dc = (None if w2 is None else
          torch.empty((t, b, h_dim), dtype=torch.bfloat16, device=dev))
    dh0 = torch.empty((b, h_dim), dtype=torch.float32, device=dev)
    _cooperative_launches("gated_train_backward", gated_train_bwd_plan, fn,
                          query, dev, h_dim, b,
                          (res, _bf16c(w1), w2b, dhs.float().contiguous(),
                           dh_T.float().contiguous(), dproj, pair, dc, dh0),
                          t, stream, (_GATED_KINDS[kind][0], _ACT_CODES[act]))
    return dproj, pair, dc, dh0


class _GatedScanTrain(torch.autograd.Function):
    """Custom backward of the gated recurrence: the twin of the JAX
    ``_gated_train`` custom VJP (rnn_pallas.py:945-974).
    ``gated_train_forward`` / ``gated_train_backward`` are looked up at
    call time, so a caller can swap in the plain versions."""

    @staticmethod
    def forward(ctx, proj, w1, w2, h0, kind, activation):
        hs, res, h_t = gated_train_forward(proj, w1, w2, h0, kind=kind,
                                           activation=activation)
        ctx.save_for_backward(res, w1, w2)
        ctx.proj_dtype = proj.dtype
        ctx.kind, ctx.activation = kind, activation
        # TBPTT reads no h_T cotangent: it arrives as zeros
        ctx.set_materialize_grads(True)
        return h_t.to(h0.dtype), hs

    @staticmethod
    def backward(ctx, dh_t, dhs):
        res, w1, w2 = ctx.saved_tensors
        dproj, dw1, dw2, dh0 = gated_train_backward(
            res, w1, w2, dhs, dh_t, ctx.proj_dtype, kind=ctx.kind,
            activation=ctx.activation)
        return dproj, dw1, dw2, dh0.to(dh_t.dtype), None, None


def gated_scan_train(proj, w1, w2, h0, *, kind, activation="tanh"):
    """Differentiable gated recurrence for training, ``gated_scan``'s
    signature and forward values: ``h_T, hs``. Gradients come from the
    reverse-time kernel (``gated_train_backward``) with bf16 residuals,
    as from the JAX custom VJP; ``mgru`` has no w2 and gets no w2
    gradient."""
    _check_gated_args("gated_scan_train", proj, w1, w2, h0, kind)
    return _GatedScanTrain.apply(proj, w1, w2, h0, kind,
                                 _gated_act(kind, activation))


# ---------------------------------------------------------------------------
# peephole LSTM (full (H, H) peephole matrices on the cell state)
# ---------------------------------------------------------------------------

# the scan (9 pointers) and the training forward and backward (10):
# pointers, then T, B, H, row0, nrows, resident, rows a block, then the
# stream
_PEEP_SCAN_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
_PEEP_TRAIN_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                        + [ctypes.c_void_p])


def _peep_scan_lib():
    lib = kernels.load("peephole_scan")
    for fn in (lib.peephole_scan_f32, lib.peephole_scan_bf16):
        fn.argtypes = _PEEP_SCAN_ARGTYPES
        fn.restype = ctypes.c_int
    lib.peephole_scan_capacity.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.peephole_scan_capacity.restype = ctypes.c_int
    return lib


def _peep_train_lib():
    lib = kernels.load("peephole_train")
    for fns, argtypes in (((lib.peephole_train_fwd_f32,
                            lib.peephole_train_fwd_bf16,
                            lib.peephole_train_bwd_f32,
                            lib.peephole_train_bwd_bf16),
                           _PEEP_TRAIN_ARGTYPES),
                          ((lib.peephole_train_dw,), _DW_ARGTYPES)):
        for fn in fns:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.peephole_train_capacity.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.peephole_train_capacity.restype = ctypes.c_int
    return lib


def _bf16c(*ws):
    """The weights ``ws`` as one contiguous bf16 tensor, concatenated
    along their last dimension."""
    return torch.cat([w.detach() for w in ws], dim=-1).to(
        torch.bfloat16).contiguous()


def _cooperative_launches(name, plan_fn, fn, query, dev, h_dim, batch,
                          tensors, t, stream, extra=()):
    """Launch the persistent kernel ``fn`` (a gated or peephole one) in the
    row chunks of ``plan_fn`` for its co-residency ``query(H, resident,
    rows, &blocks)``: the pointers of ``tensors`` (None: null), a zeroed
    barrier count a launch, then T, B, H, row0, nrows, the ints
    ``extra``, resident, rows and the stream."""
    plan = plan_fn(h_dim, batch, lambda r, rows: _capacity(
        name, query, dev, h_dim, r, rows))
    bar = torch.zeros(len(plan.launches), dtype=torch.int32, device=dev)
    ptrs = [_ptr(x) for x in tensors]
    for i, (row0, nrows) in enumerate(plan.launches):
        kernels.check(fn(*ptrs, bar.data_ptr() + 4 * i, t, batch, h_dim,
                         row0, nrows, *extra, int(plan.resident), plan.rows,
                         stream), name)
    kernels.launches[name] += 1


def _check_peep_args(name, proj, wh, pi, pf, po, c0, h0):
    _check_scan_args(name, proj, wh, c0, h0)
    h_dim = wh.shape[0]
    if any(p.shape != (h_dim, h_dim) for p in (pi, pf, po)):
        raise ValueError(f"{name}: the peephole matrices must be (H, H)")


def _peep_forward_loop(proj, wh, pi, pf, po, c0, h0, with_res):
    """The plain step loop of the forward kernels with their bf16
    roundings (rnn_pallas.py:1356-1369, :1031-1053). Returns ``hs, res
    (or None), c_T, h_T`` (carries float32)."""
    h_dim = wh.shape[0]
    t_len, b = proj.shape[:2]
    projf = _bf16f(proj)
    whf, pif, pff, pof = (_bf16f(w) for w in (wh, pi, pf, po))
    c = c0.float()
    h = h0.float()
    hs = torch.empty((t_len, b, h_dim), dtype=proj.dtype, device=proj.device)
    res = (torch.empty((t_len, b, 8 * h_dim), dtype=torch.bfloat16,
                       device=proj.device) if with_res else None)
    for t in range(t_len):
        z = projf[t] + _bf16f(h) @ whf
        cb = _bf16f(c)
        a = torch.tanh(z[:, :h_dim])
        ig = torch.sigmoid(z[:, h_dim:2 * h_dim] + cb @ pif)
        f = torch.sigmoid(z[:, 2 * h_dim:3 * h_dim] + cb @ pff)
        c_new = f * c + ig * a
        o = torch.sigmoid(z[:, 3 * h_dim:] + _bf16f(c_new) @ pof)
        tc = torch.tanh(c_new)
        h_new = o * tc
        if with_res:
            res[t] = torch.cat([a, ig, f, o, tc, c, h, c_new],
                               dim=1).to(torch.bfloat16)
        c, h = c_new, h_new
        hs[t] = h.to(proj.dtype)
    return hs, res, c, h


def peephole_scan_reference(proj, wh, pi, pf, po, c0, h0):
    """Plain PyTorch version of ``peephole_scan``, same contract: the twin
    of ``peephole_scan_mixed_reference`` (rnn_pallas.py:1413-1439), the
    operands rounded to bf16 and multiplied in float32."""
    hs, _, c, h = _peep_forward_loop(proj, wh, pi, pf, po, c0, h0, False)
    return (c.to(c0.dtype), h.to(c0.dtype)), hs


def peephole_scan(proj, wh, pi, pf, po, c0, h0):
    """Run the peephole LSTM recurrence. proj (T, B, 4H) packed a, i, f,
    o; wh (H, 4H); the peephole matrices pi, pf (on c_{t-1}) and po (on
    c_t), each (H, H); c0/h0 (B, H). Returns ``(c_T, h_T), hs`` with hs
    (T, B, H) in proj's dtype and the carry in c0's.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    ``peephole_scan_reference``. On the card the whole sequence is one
    persistent launch per row chunk of ``peephole_scan_plan`` (one for
    B <= 128 at H=1024; H <= 4224 on an H100), the training forward's
    kernel body without the residuals: hs, c_T and h_T are bit-equal to
    ``peephole_train_forward``'s. The kernel has no backward: on the card
    a tensor that requires grad under grad mode raises, and training goes
    through ``peephole_scan_train``.
    """
    name = "peephole_scan"
    _check_peep_args(name, proj, wh, pi, pf, po, c0, h0)
    if proj.device.type == "cpu":
        return peephole_scan_reference(proj, wh, pi, pf, po, c0, h0)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (proj, wh, pi, pf, po, c0, h0)):
        raise RuntimeError(
            "peephole_scan: the inference kernel has no backward, and its "
            "outputs would carry no gradient; train through "
            "peephole_scan_train, or run under torch.no_grad() / "
            "torch.inference_mode()")
    stream = _check_cuda(name, proj, wh, pi, pf, po, c0, h0)
    if not proj.is_contiguous():
        raise ValueError(f"{name}: proj must be contiguous")
    lib = _peep_scan_lib()
    fn = getattr(lib, "peephole_scan_" + _dtype_suffix(name, proj.dtype))
    hs, _, c_t, h_t = _peep_forward_launch(
        name, peephole_scan_plan, fn, lib.peephole_scan_capacity, proj, wh,
        pi, pf, po, c0, h0, stream, with_res=False)
    return (c_t.to(c0.dtype), h_t.to(c0.dtype)), hs


def peephole_train_forward_reference(proj, wh, pi, pf, po, c0, h0):
    """Plain version of ``peephole_train_forward``: the step loop of
    ``_peep_train_fwd_impl`` (rnn_pallas.py:1031-1054) with its bf16
    roundings. Returns ``hs, res, c_T, h_T`` (carries in float32)."""
    return _peep_forward_loop(proj, wh, pi, pf, po, c0, h0, True)


def peephole_train_forward(proj, wh, pi, pf, po, c0, h0):
    """Forward of the trainable peephole recurrence, ``peephole_scan``'s
    arguments. Returns ``hs`` (T, B, H) in proj's dtype, the residuals
    ``res`` (T, B, 8H) bf16 ``[a | i | f | o | tanh c_t | c_{t-1} |
    h_{t-1} | c_t]``, and ``c_T``, ``h_T`` float32.

    On the card: one persistent launch per row chunk of
    ``peephole_train_fwd_plan`` (one for B <= 128 at H=1024), two grid
    exchanges a step, tensor-core sums. ``peephole_scan`` runs the same
    kernel body, so hs, c_T and h_T are bit-equal to its; a second call
    gives the same bits.
    """
    name = "peephole_train_forward"
    _check_peep_args(name, proj, wh, pi, pf, po, c0, h0)
    if proj.device.type == "cpu":
        return peephole_train_forward_reference(proj, wh, pi, pf, po, c0, h0)
    stream = _check_cuda(name, proj, wh, pi, pf, po, c0, h0)
    if not proj.is_contiguous():
        raise ValueError(f"{name}: proj must be contiguous")
    lib = _peep_train_lib()
    fn = getattr(lib, "peephole_train_fwd_" + _dtype_suffix(name,
                                                            proj.dtype))
    return _peep_train_forward_launch(
        fn, functools.partial(lib.peephole_train_capacity, 0), proj, wh, pi,
        pf, po, c0, h0, stream)


def _peep_train_forward_launch(fn, query, proj, wh, pi, pf, po, c0, h0,
                               stream):
    """The training forward's entry point ``fn`` in
    ``peephole_train_fwd_plan``'s row chunks. Returns ``hs, res, c_T,
    h_T``."""
    return _peep_forward_launch("peephole_train_forward",
                                peephole_train_fwd_plan, fn, query, proj, wh,
                                pi, pf, po, c0, h0, stream, with_res=True)


def _peep_forward_launch(name, plan_fn, fn, query, proj, wh, pi, pf, po, c0,
                         h0, stream, with_res):
    """The operands, scratch and outputs of a persistent peephole forward's
    entry point ``fn`` (the scan's, or with ``with_res`` the training
    forward's), launched in ``plan_fn``'s row chunks. Returns ``hs, res
    (None without with_res), c_T, h_T``."""
    t, b, _ = proj.shape
    h_dim = wh.shape[0]
    dev = proj.device
    wt = wh.detach().to(torch.bfloat16).t().contiguous()   # W_h^T (4H, H)
    pt = _bf16c(po, pi, pf).t().contiguous()   # [P_o | P_i | P_f]^T (3H, H)
    h = h0.detach().float().contiguous().clone()
    c = c0.detach().float().contiguous().clone()
    hx = torch.empty((b, h_dim), dtype=torch.bfloat16, device=dev)
    cx = torch.empty((2, b, h_dim), dtype=torch.bfloat16, device=dev)
    hs = torch.empty((t, b, h_dim), dtype=proj.dtype, device=dev)
    res = (torch.empty((t, b, 8 * h_dim), dtype=torch.bfloat16, device=dev)
           if with_res else None)
    _cooperative_launches(name, plan_fn, fn, query, dev, h_dim, b,
                          (proj, wt, pt, h, c, hx, cx, hs)
                          + ((res,) if with_res else ()), t, stream)
    return hs, res, c, h


def peephole_train_dw_reference(res, dz):
    """Plain version of ``peephole_train_dw``: float32 products of the
    bf16 ``h_{t-1}``, ``c_{t-1}`` and ``c_t`` rows of ``res`` with the
    bf16 ``dz`` rows (rnn_pallas.py:1195-1208)."""
    h_dim = res.shape[-1] // 8
    r = res.reshape(-1, 8 * h_dim).float()
    d = dz.reshape(-1, 4 * h_dim).float()
    c_prev = r[:, 5 * h_dim:6 * h_dim]
    return (r[:, 6 * h_dim:7 * h_dim].T @ d,
            c_prev.T @ d[:, h_dim:2 * h_dim],
            c_prev.T @ d[:, 2 * h_dim:3 * h_dim],
            r[:, 7 * h_dim:].T @ d[:, 3 * h_dim:])


def peephole_train_dw(res, dz):
    """``dW_h = sum_t h_{t-1}^T dz``, ``dP_i = sum_t c_{t-1}^T dz_i``,
    ``dP_f = sum_t c_{t-1}^T dz_f`` and ``dP_o = sum_t c_t^T dz_o`` in
    float32 from the residuals res (T, B, 8H) and dz (T, B, 4H), both
    bf16 -> ``(dW_h (H, 4H), dP_i, dP_f, dP_o (H, H))``."""
    t, b, eight_h = res.shape
    h_dim = eight_h // 8
    if (eight_h != 8 * h_dim or dz.shape != (t, b, 4 * h_dim)
            or res.dtype != torch.bfloat16 or dz.dtype != torch.bfloat16):
        raise ValueError("peephole_train_dw: res (T, B, 8H) and dz "
                         "(T, B, 4H) must be bf16")
    if res.device.type == "cpu":
        return peephole_train_dw_reference(res, dz)
    stream = _check_cuda("peephole_train_dw", res, dz)
    if not (res.is_contiguous() and dz.is_contiguous()):
        raise ValueError("peephole_train_dw: res and dz must be contiguous")
    dwh = torch.empty((h_dim, 4 * h_dim), dtype=torch.float32,
                      device=res.device)
    dp = [torch.empty((h_dim, h_dim), dtype=torch.float32, device=res.device)
          for _ in range(3)]
    _dw_launch("peephole_train_dw", _peep_train_lib().peephole_train_dw,
               dw_plan("peephole", h_dim), h_dim, res, {"dz": dz},
               [dwh, *dp], stream)
    return (dwh, *dp)


def _check_peep_bwd_args(name, res, wh, pi, pf, po, dhs, dc_T, dh_T):
    t, b, eight_h = res.shape
    h_dim = eight_h // 8
    if (eight_h != 8 * h_dim or wh.shape != (h_dim, 4 * h_dim)
            or any(p.shape != (h_dim, h_dim) for p in (pi, pf, po))
            or dhs.shape != (t, b, h_dim) or dc_T.shape != (b, h_dim)
            or dh_T.shape != (b, h_dim) or res.dtype != torch.bfloat16):
        raise ValueError(f"{name}: shapes do not match res (T, B, 8H) bf16")
    if t < 1:
        raise ValueError(f"{name}: needs at least one timestep")


def peephole_train_backward_reference(res, wh, pi, pf, po, dhs, dc_T, dh_T,
                                      proj_dtype):
    """Plain version of ``peephole_train_backward``: the reverse step loop
    of ``_peep_train_bwd_impl`` (rnn_pallas.py:1147-1191) with its bf16
    roundings, then ``peephole_train_dw_reference``."""
    t_len, b, eight_h = res.shape
    h_dim = eight_h // 8
    whf, pif, pff, pof = (_bf16f(w) for w in (wh, pi, pf, po))
    dc = dc_T.float()
    dh = dh_T.float()
    dproj = torch.empty((t_len, b, 4 * h_dim), dtype=proj_dtype,
                        device=res.device)
    dzb = torch.empty((t_len, b, 4 * h_dim), dtype=torch.bfloat16,
                      device=res.device)
    for t in range(t_len - 1, -1, -1):
        a, ig, f, o, tc, c_prev = res[t, :, :6 * h_dim].float().split(
            h_dim, dim=1)
        dh_tot = dhs[t].float() + dh
        dz_o = (dh_tot * tc) * o * (1.0 - o)
        # c feeds h (through o's peephole) and the o-gate pre-activation
        dc = (dc + dh_tot * o * (1.0 - tc * tc)
              + _bf16f(dz_o) @ pof.T)
        dz = torch.cat([dc * ig * (1.0 - a * a), dc * a * ig * (1.0 - ig),
                        dc * c_prev * f * (1.0 - f), dz_o], dim=1)
        dproj[t] = dz.to(proj_dtype)
        dzb[t] = dz.to(torch.bfloat16)
        dzf = dzb[t].float()
        dc = (dc * f + dzf[:, h_dim:2 * h_dim] @ pif.T
              + dzf[:, 2 * h_dim:3 * h_dim] @ pff.T)
        dh = dzf @ whf.T
    dwh, dpi, dpf, dpo = peephole_train_dw_reference(res, dzb)
    return (dproj, dwh.to(wh.dtype), dpi.to(pi.dtype), dpf.to(pf.dtype),
            dpo.to(po.dtype), dc, dh)


def peephole_train_backward(res, wh, pi, pf, po, dhs, dc_T, dh_T,
                            proj_dtype):
    """Backward of the trainable peephole recurrence from its residuals.

    res (T, B, 8H) bf16, wh (H, 4H), pi/pf/po (H, H), dhs (T, B, H),
    dc_T/dh_T (B, H). Returns ``dproj`` (T, B, 4H) in ``proj_dtype``,
    ``dW_h``, ``dP_i``, ``dP_f``, ``dP_o`` each in its weight's dtype, and
    ``dc0``, ``dh0`` float32.

    On the card: one persistent launch over all reverse steps per row
    chunk of ``peephole_train_bwd_plan``, two grid exchanges a reverse
    step, then one dW launch (``peephole_train_dw``) on the bf16 dz it
    leaves behind.
    """
    name = "peephole_train_backward"
    _check_peep_bwd_args(name, res, wh, pi, pf, po, dhs, dc_T, dh_T)
    if res.device.type == "cpu":
        return peephole_train_backward_reference(res, wh, pi, pf, po, dhs,
                                                 dc_T, dh_T, proj_dtype)
    stream = _check_cuda(name, res, wh, pi, pf, po, dhs, dc_T, dh_T)
    lib = _peep_train_lib()
    fn = getattr(lib, "peephole_train_bwd_" + _dtype_suffix(name,
                                                            proj_dtype))
    if not res.is_contiguous():
        raise ValueError(f"{name}: res must be contiguous")
    dproj, dz, dc0, dh0 = _peep_train_backward_launch(
        fn, functools.partial(lib.peephole_train_capacity, 1), res, wh, pi,
        pf, po, dhs, dc_T, dh_T, proj_dtype, stream)
    dwh, dpi, dpf, dpo = peephole_train_dw(res, dz)
    return (dproj, dwh.to(wh.dtype), dpi.to(pi.dtype), dpf.to(pf.dtype),
            dpo.to(po.dtype), dc0, dh0)


def _peep_train_backward_launch(fn, query, res, wh, pi, pf, po, dhs, dc_T,
                                dh_T, proj_dtype, stream):
    """The operands, scratch and outputs of the training backward's entry
    point ``fn``, launched in ``peephole_train_bwd_plan``'s row chunks.
    Returns ``dproj``, the bf16 ``dz`` it leaves for the dW contractions,
    ``dc0`` and ``dh0``."""
    t, b, eight_h = res.shape
    h_dim = eight_h // 8
    dev = res.device
    whb = _bf16c(wh)
    pm = _bf16c(pi, pf, po)                      # [P_i | P_f | P_o] (H, 3H)
    dhs_f = dhs.float().contiguous()
    dh_t = dh_T.float().contiguous()
    dc = dc_T.float().contiguous().clone()
    dproj = torch.empty((t, b, 4 * h_dim), dtype=proj_dtype, device=dev)
    dz = torch.empty((t, b, 4 * h_dim), dtype=torch.bfloat16, device=dev)
    dh0 = torch.empty((b, h_dim), dtype=torch.float32, device=dev)
    _cooperative_launches("peephole_train_backward", peephole_train_bwd_plan,
                          fn, query, dev, h_dim, b,
                          (res, whb, pm, dhs_f, dh_t, dc, dproj, dz, dh0), t,
                          stream)
    return dproj, dz, dc, dh0


class _PeepholeScanTrain(torch.autograd.Function):
    """Custom backward of the peephole recurrence: the twin of the JAX
    ``peephole_scan_pallas_train`` custom VJP (rnn_pallas.py:1270-1303).
    ``peephole_train_forward`` / ``peephole_train_backward`` are looked up
    at call time, so a caller can swap in the plain versions."""

    @staticmethod
    def forward(ctx, proj, wh, pi, pf, po, c0, h0):
        hs, res, c_t, h_t = peephole_train_forward(proj, wh, pi, pf, po, c0,
                                                   h0)
        ctx.save_for_backward(res, wh, pi, pf, po)
        ctx.proj_dtype = proj.dtype
        # TBPTT reads no c_T / h_T cotangent: they arrive as zeros
        ctx.set_materialize_grads(True)
        return c_t.to(c0.dtype), h_t.to(c0.dtype), hs

    @staticmethod
    def backward(ctx, dc_t, dh_t, dhs):
        res, wh, pi, pf, po = ctx.saved_tensors
        dproj, dwh, dpi, dpf, dpo, dc0, dh0 = peephole_train_backward(
            res, wh, pi, pf, po, dhs, dc_t, dh_t, ctx.proj_dtype)
        return (dproj, dwh, dpi, dpf, dpo, dc0.to(dc_t.dtype),
                dh0.to(dh_t.dtype))


def peephole_scan_train(proj, wh, pi, pf, po, c0, h0):
    """Differentiable peephole recurrence for training, ``peephole_scan``'s
    signature and forward values: ``(c_T, h_T), hs`` (the persistent
    training forward, ``peephole_train_forward``, runs the scan's kernel
    body). Gradients
    (dproj, dW_h, dP_i, dP_f, dP_o, dc0, dh0) come from the reverse-time
    kernel (``peephole_train_backward``) with bf16 residuals, as from the
    JAX custom VJP."""
    _check_peep_args("peephole_scan_train", proj, wh, pi, pf, po, c0, h0)
    c_t, h_t, hs = _PeepholeScanTrain.apply(proj, wh, pi, pf, po, c0, h0)
    return (c_t, h_t), hs
