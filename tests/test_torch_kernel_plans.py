"""Host-side layouts of the persistent LSTM kernels (``lstm_scan`` and the
training forward, which share one kernel body, and the training
backward), of the persistent gated kernels and of the persistent
peephole kernels (each family's scan and training forward share one
kernel body; then its training backward), and of the tensor-core dW
GEMM shared by the three training backwards (``ops/rnn_cuda.py``
``lstm_scan_plan``, ``lstm_train_bwd_plan``, ``gated_scan_plan``,
``gated_train_fwd_plan``, ``gated_train_bwd_plan``,
``peephole_scan_plan``, ``peephole_train_fwd_plan``,
``peephole_train_bwd_plan`` and ``dw_plan``), on the CPU.

The kernels run only on the card; what they are handed is plain Python,
and is checked here: every (batch row, hidden unit) cell and every gate
column of the scan and of the backward is owned by exactly one thread of
one block, every dz column of the backward's product is reduced by
exactly one warp, and every dW output element by exactly one tile; each
block's shared memory fits the card's 227 KB; the training forward is
handed ``lstm_scan``'s plan and arguments plus its residuals; and the dW
problem descriptors (column offsets and row
strides into the residuals and gradients) address the same columns as
the plain versions ``lstm_train_dw_reference``, ``gated_train_dw_reference``
and ``peephole_train_dw_reference``: running the contraction on strided
views built from the descriptors gives the references' results.
"""

import contextlib

import numpy as np
import pytest
import torch

from nnacousticmodeling_tpu_torch import kernels
from nnacousticmodeling_tpu_torch.ops import rnn_cuda
from nnacousticmodeling_tpu_torch.ops.rnn_cuda import (
    DW_CONFIGS,
    DW_TILE_M,
    GATED_NARROW_ROWS,
    GATED_ROWS,
    GATED_UNITS,
    SCAN_ROWS,
    SCAN_UNITS,
    BWD_KC,
    PEEP_KC,
    PEEP_NARROW_ROWS,
    PEEP_ROWS,
    PEEP_UNITS,
    SMEM_LIMIT,
    bwd_w_resident,
    dw_plan,
    gated_scan_plan,
    gated_train_bwd_plan,
    gated_train_fwd_plan,
    lstm_scan_plan,
    lstm_train_bwd_plan,
    peephole_scan_plan,
    peephole_train_bwd_plan,
    peephole_train_fwd_plan,
    scan_w_resident,
)

HS = [32, 40, 64, 1024, 2048]
BS = [1, 3, 33, 64, 128]
#: co-resident blocks of the scan on a 132-SM H100: one block an SM with
#: W_h resident (~218 KB of shared memory at H=1024), two streamed
H100_BLOCKS = {True: 132, False: 264}
THREADS = 256   # lstm_scan.cu: 16 units x 16 row groups of 4 rows
BWD_BS = BS + [300]
BWD_WARPS = 8   # lstm_train.cu's backward: one 16-wide slice of a chunk each


def _scan_cells(plan, h_dim, batch):
    """How often each (row, unit) cell and each (row, gate column) is
    owned, following lstm_scan.cu's block and thread layout."""
    cells = np.zeros((batch, h_dim), np.int64)
    cols = np.zeros((batch, 4 * h_dim), np.int64)
    tid = np.arange(THREADS)
    u, rq = tid % SCAN_UNITS, tid // SCAN_UNITS
    for row0, nrows in plan.launches:
        gx, gy = plan.grid(nrows)
        for bx in range(gx):
            for by in range(gy):
                for q in range(4):
                    b = row0 + by * SCAN_ROWS + rq + 16 * q
                    j = bx * SCAN_UNITS + u
                    own = (j < h_dim) & (b < row0 + nrows)
                    np.add.at(cells, (b[own], j[own]), 1)
                    for g in range(4):
                        np.add.at(cols, (b[own], g * h_dim + j[own]), 1)
    return cells, cols


@pytest.mark.parametrize("batch", BS)
@pytest.mark.parametrize("h_dim", HS)
def test_scan_plan_owns_every_cell_once(h_dim, batch):
    resident = scan_w_resident(h_dim)
    assert resident == (h_dim <= 1088)
    plan = lstm_scan_plan(h_dim, batch, H100_BLOCKS[resident])
    assert plan.resident == resident
    assert plan.smem_bytes <= SMEM_LIMIT
    for _, nrows in plan.launches:
        gx, gy = plan.grid(nrows)
        assert gx * gy <= H100_BLOCKS[resident]
    assert sum(n for _, n in plan.launches) == batch
    if h_dim == 1024 and batch <= 128:
        assert len(plan.launches) == 1    # the serving path: one launch
    cells, cols = _scan_cells(plan, h_dim, batch)
    assert (cells == 1).all() and (cols == 1).all()


@pytest.mark.parametrize("h_dim,batch", [(40, 200), (1024, 300), (2048, 3)])
def test_scan_plan_cuts_rows_into_co_resident_launches(h_dim, batch):
    """A grid of just the units' blocks holds one row tile a launch."""
    unit_blocks = -(-h_dim // SCAN_UNITS)
    plan = lstm_scan_plan(h_dim, batch, unit_blocks)
    assert len(plan.launches) == -(-batch // SCAN_ROWS)
    cells, cols = _scan_cells(plan, h_dim, batch)
    assert (cells == 1).all() and (cols == 1).all()


def test_scan_plan_refuses_a_grid_that_cannot_be_co_resident():
    with pytest.raises(ValueError, match="co-resident"):
        lstm_scan_plan(4096, 8, 200)


@pytest.mark.parametrize("batch", BWD_BS)
@pytest.mark.parametrize("h_dim", HS)
def test_train_bwd_plan_owns_every_cell_and_column_once(h_dim, batch):
    """The backward's blocks and threads own the cells as the scan's do
    (16 units x 4 row groups a thread layout), and its warps split every
    128-wide chunk of the 4H reduction into 16-wide slices."""
    resident = bwd_w_resident(h_dim)
    assert resident == (h_dim <= 1120)
    plan = lstm_train_bwd_plan(h_dim, batch, H100_BLOCKS[resident])
    assert plan.resident == resident
    assert plan.smem_bytes == rnn_cuda.bwd_smem_bytes(h_dim, resident)
    assert plan.smem_bytes <= SMEM_LIMIT
    # the drained ring holds the 8 warps' f32 partials (64 rows x 20)
    ring = plan.smem_bytes - (SCAN_UNITS * (-(-4 * h_dim // BWD_KC)
                                            * BWD_KC + 8) * 2
                              if resident else 0)
    assert BWD_WARPS * SCAN_ROWS * (SCAN_UNITS + 4) * 4 <= ring
    for _, nrows in plan.launches:
        gx, gy = plan.grid(nrows)
        assert gx * gy <= H100_BLOCKS[resident]
    assert sum(n for _, n in plan.launches) == batch
    if h_dim == 1024 and batch <= 128:
        assert len(plan.launches) == 1    # the training path: one launch
    cells, cols = _scan_cells(plan, h_dim, batch)
    assert (cells == 1).all() and (cols == 1).all()
    extent = -(-4 * h_dim // BWD_KC) * BWD_KC
    reduced = np.zeros(extent, np.int64)
    for kc in range(extent // BWD_KC):
        for warp in range(BWD_WARPS):
            reduced[kc * BWD_KC + warp * 16:kc * BWD_KC + warp * 16 + 16] += 1
    assert (reduced == 1).all() and extent >= 4 * h_dim


def test_train_bwd_plan_streams_w_exactly_where_it_does_not_fit():
    for h_dim in range(1000, 1300, 4):
        fits = rnn_cuda.bwd_smem_bytes(h_dim, True) <= SMEM_LIMIT
        assert bwd_w_resident(h_dim) == fits
        assert lstm_train_bwd_plan(h_dim, 8, 264).resident == fits
    with pytest.raises(ValueError, match="co-resident"):
        lstm_train_bwd_plan(4096, 8, 200)


@pytest.mark.parametrize("h_dim,batch", [(40, 3), (1024, 128), (1024, 300),
                                         (2048, 200)])
def test_train_forward_is_handed_the_scan_plan(monkeypatch, h_dim, batch):
    """lstm_scan and the training forward run one kernel body: the forward
    gets lstm_scan_plan's chunks and the scan's arguments, plus the
    residuals, in the order of the C entry points' argtypes."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda _: contextlib.nullcontext())
    monkeypatch.setattr(rnn_cuda, "_CAPACITY", {})
    resident = scan_w_resident(h_dim)
    t = 3
    proj = torch.zeros(t, batch, 4 * h_dim)
    wh = torch.zeros(h_dim, 4 * h_dim)
    c0 = h0 = torch.zeros(batch, h_dim)
    calls = {}

    def query(h, res_flag, blocks):
        blocks._obj.value = H100_BLOCKS[resident]
        return 0

    def entry(name):
        def fn(*args):
            calls.setdefault(name, []).append(args)
            return 0
        return fn

    before = dict(kernels.launches)
    try:
        res = torch.empty(t, batch, 7 * h_dim, dtype=torch.bfloat16)
        for name, extra in (("lstm_scan", None), ("lstm_train_forward", res)):
            hs, c, h = rnn_cuda._persistent_recurrence(
                name, entry(name), query, proj, wh, c0, h0, None, extra)
            assert hs.shape == (t, batch, h_dim) and c.shape == h.shape
    finally:
        kernels.launches.clear()
        kernels.launches.update(before)
    plan = lstm_scan_plan(h_dim, batch, H100_BLOCKS[resident])
    scan, fwd = calls["lstm_scan"], calls["lstm_train_forward"]
    assert len(scan) == len(fwd) == len(plan.launches)
    assert len(scan[0]) == len(rnn_cuda._SCAN_ARGTYPES)
    assert len(fwd[0]) == len(rnn_cuda._FWD_ARGTYPES)
    for i, (row0, nrows) in enumerate(plan.launches):
        assert fwd[i][6] == res.data_ptr()
        assert fwd[i][-7:] == (t, batch, h_dim, row0, nrows, int(resident),
                               None)
        assert scan[i][-7:] == fwd[i][-7:]
        assert fwd[i][7] - fwd[0][7] == 4 * i      # one barrier a launch


# ---- the persistent peephole training kernels -----------------------------

#: co-resident blocks of the peephole training kernels on a 132-SM H100,
#: by (resident, rows a block): one block an SM with the weight slice
#: resident (~220 KB), two streamed, four streamed at 64 rows
H100_PEEP_BLOCKS = {(True, 128): 132, (False, 128): 264, (False, 64): 528}
#: the peephole plans' sizes: HS, and two widths whose grid of streamed
#: 128-row blocks is not co-resident (64-row blocks)
PEEP_HS = HS + [2120, 4096]


def _h100_peep(resident, rows):
    return H100_PEEP_BLOCKS[resident, rows]


PEEP_PLANS = {"forward": (peephole_train_fwd_plan,
                          rnn_cuda.peephole_fwd_smem_bytes),
              "backward": (peephole_train_bwd_plan,
                           rnn_cuda.peephole_bwd_smem_bytes),
              "scan": (peephole_scan_plan, rnn_cuda.peephole_fwd_smem_bytes)}


def _peep_cells(plan, h_dim, batch):
    """How often each (row, unit) cell and each (row, gate column) is
    owned, following peephole_persistent.cuh's layout: block (x, y) owns
    units x*8.. for rows row0 + y*rows.. (rows / 16 warps); lane (g, q)
    of warp w owns, in every gate's n8 tile, rows w*16 + g (+ 8) and
    units 2q, 2q + 1."""
    cells = np.zeros((batch, h_dim), np.int64)
    cols = np.zeros((batch, 4 * h_dim), np.int64)
    warp, lane = np.divmod(np.arange(plan.rows // 16 * 32), 32)
    for row0, nrows in plan.launches:
        gx, gy = plan.grid(nrows)
        for bx in range(gx):
            for by in range(gy):
                for e in range(4):
                    b = (row0 + by * plan.rows + warp * 16 + lane // 4
                         + 8 * (e // 2))
                    j = bx * PEEP_UNITS + 2 * (lane % 4) + e % 2
                    own = (j < h_dim) & (b < row0 + nrows)
                    np.add.at(cells, (b[own], j[own]), 1)
                    for g in range(4):
                        np.add.at(cols, (b[own], g * h_dim + j[own]), 1)
    return cells, cols


@pytest.mark.parametrize("batch", BWD_BS)
@pytest.mark.parametrize("h_dim", PEEP_HS)
@pytest.mark.parametrize("kind", ["forward", "backward", "scan"])
def test_peephole_plan_owns_every_cell_once(kind, h_dim, batch):
    """Each thread of the forward (and of the scan, the same body) owns
    all four gate columns of its cells (the cell update runs in its
    registers); each of the backward owns the dh, dc and four dz columns
    of its cells."""
    plan_fn, smem = PEEP_PLANS[kind]
    plan = plan_fn(h_dim, batch, _h100_peep)
    assert plan.resident == (h_dim <= 1024)
    rows = PEEP_ROWS if h_dim <= 2112 else PEEP_NARROW_ROWS
    assert (plan.units, plan.rows) == (PEEP_UNITS, rows)
    assert plan.smem_bytes == smem(h_dim, plan.resident, rows) <= SMEM_LIMIT
    for _, nrows in plan.launches:
        gx, gy = plan.grid(nrows)
        assert gx * gy <= H100_PEEP_BLOCKS[plan.resident, rows]
    assert sum(n for _, n in plan.launches) == batch
    if h_dim == 1024 and batch <= 128:
        assert len(plan.launches) == 1    # the training path: one launch
    cells, cols = _peep_cells(plan, h_dim, batch)
    assert (cells == 1).all() and (cols == 1).all()


@pytest.mark.parametrize("h_dim", HS)
def test_peephole_bwd_products_reduce_every_dz_column_once(h_dim):
    """A reverse step's two products walk the o block, then the a, i and
    f blocks, each in chunks of PEEP_KC over H rounded up to whole chunks:
    together they reduce every one of the 4H dz columns exactly once, and
    only the i, f and o blocks reach the dc rows."""
    resident = rnn_cuda.peephole_bwd_w_resident(h_dim, 132)
    kc = PEEP_KC[resident]
    nkb = -(-h_dim // kc)
    dh_cols = np.zeros(4 * h_dim, np.int64)
    dc_cols = np.zeros(4 * h_dim, np.int64)
    for blk0, nblk in ((3, 1), (0, 3)):
        for c in range(nblk * nkb):
            blk, n0 = blk0 + c // nkb, (c % nkb) * kc
            cols = blk * h_dim + np.arange(n0, min(n0 + kc, h_dim))
            dh_cols[cols] += 1
            if blk >= 1:
                dc_cols[cols] += 1
    assert (dh_cols == 1).all()
    assert (dc_cols[:h_dim] == 0).all() and (dc_cols[h_dim:] == 1).all()


@pytest.mark.parametrize("kind", ["forward", "backward", "scan"])
def test_peephole_plan_streams_exactly_where_the_slice_does_not_fit(kind):
    plan_fn, smem = PEEP_PLANS[kind]
    for h_dim in range(960, 1200, 8):
        fits = smem(h_dim, True) <= SMEM_LIMIT
        assert plan_fn(h_dim, 8, _h100_peep).resident == fits
        assert smem(h_dim, False) <= SMEM_LIMIT // 2    # two blocks an SM
    assert smem(4096, False, PEEP_NARROW_ROWS) <= SMEM_LIMIT // 4
    # a resident grid that the card cannot hold at one block an SM streams
    small = {(True, 128): 114, (False, 128): 228, (False, 64): 456}
    assert not plan_fn(1024, 8, lambda r, rows: small[r, rows]).resident
    # 64-row blocks exactly where H/8 streamed 128-row blocks are not
    # co-resident; beyond what four blocks an SM hold, refused
    for h_dim, rows in ((2112, 128), (2120, 64), (4224, 64)):
        assert plan_fn(h_dim, 8, _h100_peep).rows == rows
    with pytest.raises(ValueError, match="co-resident"):
        plan_fn(4232, 8, _h100_peep)


@pytest.mark.parametrize("h_dim,batch", [(40, 3), (1024, 128), (1024, 300),
                                         (2048, 200), (2120, 3)])
@pytest.mark.parametrize("kind", ["forward", "backward"])
def test_peephole_train_wrappers_are_handed_their_plans(monkeypatch, kind,
                                                       h_dim, batch):
    """Each launch of a peephole training kernel gets its plan's row chunk,
    its residency flag and a barrier count of its own, after the
    pointers in the order of the C entry points' argtypes."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda _: contextlib.nullcontext())
    monkeypatch.setattr(rnn_cuda, "_CAPACITY", {})
    t = 3
    rng = np.random.default_rng(h_dim + batch)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    wh = rand(h_dim, 4 * h_dim)
    peeps = [rand(h_dim, h_dim) for _ in range(3)]
    calls = []

    def query(h, res_flag, rows, blocks):
        blocks._obj.value = H100_PEEP_BLOCKS[bool(res_flag), rows]
        return 0

    def entry(*args):
        calls.append(args)
        return 0

    before = dict(kernels.launches)
    try:
        if kind == "forward":
            proj = rand(t, batch, 4 * h_dim)
            c0, h0 = rand(batch, h_dim), rand(batch, h_dim)
            hs, res, c, h = rnn_cuda._peep_train_forward_launch(
                entry, query, proj, wh, *peeps, c0, h0, None)
            assert hs.shape == (t, batch, h_dim) and c.shape == h.shape
            assert res.shape == (t, batch, 8 * h_dim)
        else:
            res = rand(t, batch, 8 * h_dim).to(torch.bfloat16)
            dproj, dz, dc0, dh0 = rnn_cuda._peep_train_backward_launch(
                entry, query, res, wh, *peeps, rand(t, batch, h_dim),
                rand(batch, h_dim), rand(batch, h_dim), torch.float32, None)
            assert dproj.shape == dz.shape == (t, batch, 4 * h_dim)
            assert dz.dtype == torch.bfloat16
            assert dc0.shape == dh0.shape == (batch, h_dim)
        name = f"peephole_train_{kind}"
        assert kernels.launches[name] == before.get(name, 0) + 1
    finally:
        kernels.launches.clear()
        kernels.launches.update(before)
    plan = PEEP_PLANS[kind][0](h_dim, batch, _h100_peep)
    assert len(calls) == len(plan.launches)
    for i, (row0, nrows) in enumerate(plan.launches):
        assert len(calls[i]) == len(rnn_cuda._PEEP_TRAIN_ARGTYPES)
        assert calls[i][-8:] == (t, batch, h_dim, row0, nrows,
                                 int(plan.resident), plan.rows, None)
        assert calls[i][:9] == calls[0][:9]          # the same tensors
        assert calls[i][9] - calls[0][9] == 4 * i    # one barrier a launch
    if kind == "backward":
        assert calls[0][0] == res.data_ptr()


def test_peephole_train_operands_are_the_kernels_layouts():
    """The forward's B operands are W_h^T (4H, H) and [P_o | P_i | P_f]^T
    (3H, H), rows contiguous along the reduction; the backward's are W_h
    and [P_i | P_f | P_o] (H, 3H), whose rows k are contiguous already."""
    h_dim = 24
    rng = np.random.default_rng(5)
    wh, pi, pf, po = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((h_dim, 4 * h_dim),) + ((h_dim, h_dim),) * 3)
    bf = rnn_cuda._bf16f
    pt = rnn_cuda._bf16c(po, pi, pf).t().contiguous()
    assert pt.shape == (3 * h_dim, h_dim) and pt.dtype == torch.bfloat16
    for g, p in enumerate((po, pi, pf)):
        assert torch.equal(pt[g * h_dim:(g + 1) * h_dim].float(), bf(p).T)
    pm = rnn_cuda._bf16c(pi, pf, po)
    assert pm.shape == (h_dim, 3 * h_dim) and pm.is_contiguous()
    for g, p in enumerate((pi, pf, po)):
        assert torch.equal(pm[:, g * h_dim:(g + 1) * h_dim].float(), bf(p))
    assert torch.equal(rnn_cuda._bf16c(wh).float(), bf(wh))


@pytest.mark.parametrize("h_dim,batch", [(40, 3), (1024, 128), (1024, 300),
                                         (2048, 200), (2120, 3)])
def test_peephole_scan_is_handed_the_train_forward_plan(monkeypatch, h_dim,
                                                        batch):
    """peephole_scan runs the training forward's kernel body: one launch
    per row chunk of the same plan, the same operands and scratch in the
    same order, without the residuals, and a barrier count a launch."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda _: contextlib.nullcontext())
    monkeypatch.setattr(rnn_cuda, "_CAPACITY", {})
    t = 3
    rng = np.random.default_rng(h_dim + batch)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    args = (rand(t, batch, 4 * h_dim), rand(h_dim, 4 * h_dim),
            *[rand(h_dim, h_dim) for _ in range(3)], rand(batch, h_dim),
            rand(batch, h_dim))
    calls = {}

    def query(h, res_flag, rows, blocks):
        blocks._obj.value = H100_PEEP_BLOCKS[bool(res_flag), rows]
        return 0

    def entry(name):
        def fn(*a):
            calls.setdefault(name, []).append(a)
            return 0
        return fn

    before = dict(kernels.launches)
    try:
        hs, res, c, h = rnn_cuda._peep_forward_launch(
            "peephole_scan", peephole_scan_plan, entry("scan"), query, *args,
            None, with_res=False)
        assert res is None and hs.shape == (t, batch, h_dim)
        assert c.shape == h.shape == (batch, h_dim)
        rnn_cuda._peep_train_forward_launch(entry("train"), query, *args,
                                            None)
        assert kernels.launches["peephole_scan"] == \
            before.get("peephole_scan", 0) + 1
    finally:
        kernels.launches.clear()
        kernels.launches.update(before)
    plan = peephole_scan_plan(h_dim, batch, _h100_peep)
    assert plan == peephole_train_fwd_plan(h_dim, batch, _h100_peep)
    scan, train = calls["scan"], calls["train"]
    assert len(scan) == len(train) == len(plan.launches)
    for i, (row0, nrows) in enumerate(plan.launches):
        assert len(scan[i]) == len(rnn_cuda._PEEP_SCAN_ARGTYPES)
        assert scan[i][-8:] == train[i][-8:] == (
            t, batch, h_dim, row0, nrows, int(plan.resident), plan.rows,
            None)
        assert scan[i][8] - scan[0][8] == 4 * i     # one barrier a launch


# ---- the persistent gated training forward --------------------------------

#: co-resident blocks of the gated training forward on a 132-SM H100, by
#: (resident, rows a block): one block an SM with the weight slice
#: resident (~148 KB), two streamed, four streamed at 32 rows
H100_GATED_BLOCKS = {(True, 64): 132, (False, 64): 264, (False, 32): 528}
#: HS, the widest resident width, a streamed one, and one whose grid of
#: streamed 64-row blocks is not co-resident (32-row blocks)
GATED_HS = HS + [1792, 4240]
GATED_KINDS = {"gru": 3, "mgru_r": 3, "mgru": 2}


def _h100_gated(resident, rows):
    return H100_GATED_BLOCKS[resident, rows]


def _gated_cells(plan, h_dim, batch, gp):
    """How often each (row, unit) cell and each (row, gate column) is
    owned, following gated_persistent.cuh's layout: block (x, y) owns
    units x*16.. for rows row0 + y*rows..; warp w owns rows (w % (rows /
    16))*16.. and units (w // (rows / 16))*8..; lane (g, q) owns, in every
    gate's n8 tile, rows g and g + 8 and units 2q, 2q + 1 of them."""
    cells = np.zeros((batch, h_dim), np.int64)
    cols = np.zeros((batch, gp * h_dim), np.int64)
    row_warps = plan.rows // 16
    warps = row_warps * plan.units // 8
    warp, lane = np.divmod(np.arange(warps * 32), 32)
    wr, wu = warp % row_warps, warp // row_warps
    for row0, nrows in plan.launches:
        gx, gy = plan.grid(nrows)
        for bx in range(gx):
            for by in range(gy):
                for e in range(4):
                    b = (row0 + by * plan.rows + wr * 16 + lane // 4
                         + 8 * (e // 2))
                    j = bx * plan.units + wu * 8 + 2 * (lane % 4) + e % 2
                    own = (j < h_dim) & (b < row0 + nrows)
                    np.add.at(cells, (b[own], j[own]), 1)
                    for g in range(gp):
                        np.add.at(cols, (b[own], g * h_dim + j[own]), 1)
    return cells, cols


@pytest.mark.parametrize("batch", BWD_BS)
@pytest.mark.parametrize("h_dim", GATED_HS)
@pytest.mark.parametrize("kind", sorted(GATED_KINDS))
def test_gated_plan_owns_every_cell_once(kind, h_dim, batch):
    """Each thread owns every gate column of its cells (the cell update
    runs in its registers), for every kind alike; one launch at the
    training width; the slice resident up to H=1792, 32-row blocks where
    the H/16 streamed blocks of 64 rows are not co-resident."""
    plan = gated_train_fwd_plan(h_dim, batch, _h100_gated)
    assert plan.resident == (h_dim <= 1792)
    rows = GATED_ROWS if h_dim <= 4224 else GATED_NARROW_ROWS
    assert (plan.units, plan.rows) == (GATED_UNITS, rows)
    assert plan.smem_bytes == rnn_cuda.gated_fwd_smem_bytes(
        h_dim, plan.resident, rows) <= SMEM_LIMIT
    for _, nrows in plan.launches:
        gx, gy = plan.grid(nrows)
        assert gx * gy <= H100_GATED_BLOCKS[plan.resident, rows]
    assert sum(n for _, n in plan.launches) == batch
    if h_dim == 1024 and batch <= 128:
        assert len(plan.launches) == 1    # the training path: one launch
    if h_dim == 1024 and batch == 300:
        assert [n for _, n in plan.launches] == [128, 128, 44]
    cells, cols = _gated_cells(plan, h_dim, batch, GATED_KINDS[kind])
    assert (cells == 1).all() and (cols == 1).all()


def test_gated_plan_streams_exactly_where_the_slice_does_not_fit():
    smem = rnn_cuda.gated_fwd_smem_bytes
    for h_dim in range(1600, 2000, 8):
        fits = smem(h_dim, True) <= SMEM_LIMIT
        assert fits == (h_dim <= 1792)
        assert gated_train_fwd_plan(h_dim, 8, _h100_gated).resident == fits
        assert smem(h_dim, False) <= SMEM_LIMIT // 2    # two blocks an SM
    assert smem(8448, False, GATED_NARROW_ROWS) <= SMEM_LIMIT // 4
    # a grid of the units' resident blocks that the card cannot hold at
    # one block an SM streams, here in two row chunks
    small = {(True, 64): 60, (False, 64): 120, (False, 32): 240}
    plan = gated_train_fwd_plan(1024, 128, lambda r, rows: small[r, rows])
    assert not plan.resident and plan.launches == ((0, 64), (64, 64))
    # 32-row blocks exactly where H/16 streamed 64-row blocks are not
    # co-resident; beyond what four blocks an SM hold, refused
    for h_dim, rows in ((4224, 64), (4240, 32), (8448, 32)):
        assert gated_train_fwd_plan(h_dim, 8, _h100_gated).rows == rows
    with pytest.raises(ValueError, match="co-resident"):
        gated_train_fwd_plan(8464, 8, _h100_gated)


@pytest.mark.parametrize("h_dim,batch", [(40, 3), (1024, 128), (1024, 300),
                                         (2048, 4), (4240, 3)])
@pytest.mark.parametrize("kind", sorted(GATED_KINDS))
def test_gated_train_forward_is_handed_its_plan(monkeypatch, kind, h_dim,
                                                batch):
    """Each launch of the gated training forward gets its plan's row
    chunk, the kind's and activation's codes, the residency flag and a
    barrier count of its own, after the pointers in the order of the C
    entry points' argtypes; mgru gets no w2^T and no r h exchange."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda _: contextlib.nullcontext())
    monkeypatch.setattr(rnn_cuda, "_CAPACITY", {})
    t, gp = 3, GATED_KINDS[kind]
    rng = np.random.default_rng(h_dim + batch)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    proj = rand(t, batch, gp * h_dim)
    w1 = rand(h_dim, 2 * h_dim)
    w2 = None if kind == "mgru" else rand(h_dim, h_dim)
    h0 = rand(batch, h_dim)
    act = "tanh" if kind == "gru" else "relu"
    calls = []

    def query(h, res_flag, rows, blocks):
        blocks._obj.value = H100_GATED_BLOCKS[bool(res_flag), rows]
        return 0

    def entry(*args):
        calls.append(args)
        return 0

    before = dict(kernels.launches)
    try:
        hs, res, h = rnn_cuda._gated_train_forward_launch(
            entry, query, proj, w1, w2, h0, kind, act, None)
        assert hs.shape == (t, batch, h_dim) and hs.dtype == proj.dtype
        assert res.shape == (t, batch, 4 * h_dim)
        assert res.dtype == torch.bfloat16
        assert h.shape == (batch, h_dim) and h.dtype == torch.float32
        assert kernels.launches["gated_train_forward"] == \
            before.get("gated_train_forward", 0) + 1
    finally:
        kernels.launches.clear()
        kernels.launches.update(before)
    plan = gated_train_fwd_plan(h_dim, batch, _h100_gated)
    codes = {"gru": (0, 0), "mgru_r": (1, 1), "mgru": (2, 1)}[kind]
    assert len(calls) == len(plan.launches)
    for i, (row0, nrows) in enumerate(plan.launches):
        assert len(calls[i]) == len(rnn_cuda._GATED_FWD_ARGTYPES)
        assert calls[i][-10:] == (t, batch, h_dim, row0, nrows, *codes,
                                  int(plan.resident), plan.rows, None)
        assert calls[i][:8] == calls[0][:8]          # the same tensors
        assert calls[i][8] - calls[0][8] == 4 * i    # one barrier a launch
    assert calls[0][0] == proj.data_ptr() and calls[0][7] == res.data_ptr()
    # w2^T and the r h exchange only where there is a reset gate
    assert (calls[0][2] is None) == (calls[0][5] is None) == (kind == "mgru")


#: the gated plans other than the training forward's, with their shared
#: memory: the scan runs the forward's body, the backward its own
GATED_PLANS = {"scan": (gated_scan_plan, rnn_cuda.gated_fwd_smem_bytes),
               "backward": (gated_train_bwd_plan,
                            rnn_cuda.gated_bwd_smem_bytes)}


@pytest.mark.parametrize("batch", BWD_BS)
@pytest.mark.parametrize("h_dim", GATED_HS)
@pytest.mark.parametrize("kind", sorted(GATED_KINDS))
@pytest.mark.parametrize("which", sorted(GATED_PLANS))
def test_gated_scan_and_bwd_plans_own_every_cell_once(which, kind, h_dim,
                                                      batch):
    """The scan's threads own every gate column of their cells, as the
    training forward's; the backward's own the dh, dzpre, dcpre and drpre
    columns of theirs (its dproj columns), in the same layout: 16 units x
    64 rows a block, 32 rows where the H/16 streamed 64-row blocks are not
    co-resident, the slice resident up to H=1792."""
    plan_fn, smem = GATED_PLANS[which]
    plan = plan_fn(h_dim, batch, _h100_gated)
    if which == "scan":
        assert plan == gated_train_fwd_plan(h_dim, batch, _h100_gated)
    assert plan.resident == (h_dim <= 1792)
    rows = GATED_ROWS if h_dim <= 4224 else GATED_NARROW_ROWS
    assert (plan.units, plan.rows) == (GATED_UNITS, rows)
    assert plan.smem_bytes == smem(h_dim, plan.resident, rows) <= SMEM_LIMIT
    for _, nrows in plan.launches:
        gx, gy = plan.grid(nrows)
        assert gx * gy <= H100_GATED_BLOCKS[plan.resident, rows]
    assert sum(n for _, n in plan.launches) == batch
    if h_dim == 1024 and batch <= 128:
        assert len(plan.launches) == 1    # serving and training: one launch
    cells, cols = _gated_cells(plan, h_dim, batch, GATED_KINDS[kind])
    assert (cells == 1).all() and (cols == 1).all()


@pytest.mark.parametrize("h_dim", HS + [1792, 4240])
@pytest.mark.parametrize("kind", sorted(GATED_KINDS))
def test_gated_bwd_products_reduce_every_column_once(kind, h_dim):
    """A reverse step's products: drh over the H dc columns against the w2
    group (gru, mgru_r), then dh over the 2H pair columns, as two groups
    of H, against the two w1 groups, each in chunks of PEEP_KC over H
    rounded up to whole chunks: every column is reduced exactly once,
    against the group that holds its weights."""
    resident = rnn_cuda._w_resident(rnn_cuda.gated_bwd_smem_bytes, h_dim,
                                    GATED_UNITS, GATED_ROWS, 132)
    kc = PEEP_KC[resident]
    nkb = -(-h_dim // kc)
    seen = {"dc": np.zeros(h_dim, np.int64),
            "pair": np.zeros(2 * h_dim, np.int64)}
    groups = {"dc": np.full(h_dim, -1), "pair": np.full(2 * h_dim, -1)}
    products = [("pair", 0, 2)]
    if kind != "mgru":
        products.insert(0, ("dc", 2, 1))
    for x, g0, ng in products:
        for c in range(ng * nkb):
            g, n0 = g0 + c // nkb, (c % nkb) * kc
            cols = (g - g0) * h_dim + np.arange(n0, min(n0 + kc, h_dim))
            seen[x][cols] += 1
            groups[x][cols] = g
    assert (seen["pair"] == 1).all()
    assert (groups["pair"] == np.repeat([0, 1], h_dim)).all()
    assert (seen["dc"] == (kind != "mgru")).all()
    if kind != "mgru":
        assert (groups["dc"] == 2).all()


@pytest.mark.parametrize("which", sorted(GATED_PLANS))
def test_gated_scan_and_bwd_plans_stream_exactly_where_the_slice_does_not_fit(
        which):
    plan_fn, smem = GATED_PLANS[which]
    for h_dim in range(1600, 2000, 8):
        fits = smem(h_dim, True) <= SMEM_LIMIT
        assert fits == (h_dim <= 1792)
        assert plan_fn(h_dim, 8, _h100_gated).resident == fits
        assert smem(h_dim, False) <= SMEM_LIMIT // 2    # two blocks an SM
    assert smem(8448, False, GATED_NARROW_ROWS) <= SMEM_LIMIT // 4
    # a grid of the units' resident blocks that the card cannot hold at
    # one block an SM streams, here in two row chunks
    small = {(True, 64): 60, (False, 64): 120, (False, 32): 240}
    plan = plan_fn(1024, 128, lambda r, rows: small[r, rows])
    assert not plan.resident and plan.launches == ((0, 64), (64, 64))
    # 32-row blocks exactly where H/16 streamed 64-row blocks are not
    # co-resident; beyond what four blocks an SM hold, refused: there is
    # no per-step fallback
    for h_dim, rows in ((4224, 64), (4240, 32), (8448, 32)):
        assert plan_fn(h_dim, 8, _h100_gated).rows == rows
    with pytest.raises(ValueError, match="co-resident"):
        plan_fn(8464, 8, _h100_gated)


def _gated_launch_case(kind, h_dim, batch, t=3):
    rng = np.random.default_rng(h_dim + batch)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    w1 = rand(h_dim, 2 * h_dim)
    w2 = None if kind == "mgru" else rand(h_dim, h_dim)
    return rand, w1, w2, ("tanh" if kind == "gru" else "relu")


def _gated_query(h, res_flag, rows, blocks):
    blocks._obj.value = H100_GATED_BLOCKS[bool(res_flag), rows]
    return 0


@pytest.mark.parametrize("h_dim,batch", [(40, 3), (1024, 128), (1024, 300),
                                         (2048, 4), (4240, 3)])
@pytest.mark.parametrize("kind", sorted(GATED_KINDS))
def test_gated_train_backward_is_handed_its_plan(monkeypatch, kind, h_dim,
                                                 batch):
    """Each launch of the gated training backward gets its plan's row
    chunk, the kind's and activation's codes, the residency flag and a
    barrier count of its own, after the pointers in the order of the C
    entry points' argtypes; mgru gets no w2 and no dc exchange, and the
    pair and dc it is handed are what the dW contractions read."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda _: contextlib.nullcontext())
    monkeypatch.setattr(rnn_cuda, "_CAPACITY", {})
    t, gp = 3, GATED_KINDS[kind]
    rand, w1, w2, act = _gated_launch_case(kind, h_dim, batch, t)
    res = rand(t, batch, 4 * h_dim).to(torch.bfloat16)
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    before = dict(kernels.launches)
    try:
        dproj, pair, dc, dh0 = rnn_cuda._gated_train_backward_launch(
            entry, _gated_query, res, w1, w2, rand(t, batch, h_dim),
            rand(batch, h_dim), torch.bfloat16, kind, act, None)
        assert dproj.shape == (t, batch, gp * h_dim)
        assert dproj.dtype == torch.bfloat16
        assert pair.shape == (t, batch, 2 * h_dim)
        assert pair.dtype == torch.bfloat16
        assert (dc is None) == (kind == "mgru")
        if dc is not None:
            assert dc.shape == (t, batch, h_dim)
            assert dc.dtype == torch.bfloat16
        assert dh0.shape == (batch, h_dim) and dh0.dtype == torch.float32
        assert kernels.launches["gated_train_backward"] == \
            before.get("gated_train_backward", 0) + 1
    finally:
        kernels.launches.clear()
        kernels.launches.update(before)
    plan = gated_train_bwd_plan(h_dim, batch, _h100_gated)
    codes = {"gru": (0, 0), "mgru_r": (1, 1), "mgru": (2, 1)}[kind]
    assert len(calls) == len(plan.launches)
    for i, (row0, nrows) in enumerate(plan.launches):
        assert len(calls[i]) == len(rnn_cuda._GATED_BWD_ARGTYPES)
        assert calls[i][-10:] == (t, batch, h_dim, row0, nrows, *codes,
                                  int(plan.resident), plan.rows, None)
        assert calls[i][:9] == calls[0][:9]          # the same tensors
        assert calls[i][9] - calls[0][9] == 4 * i    # one barrier a launch
    assert calls[0][0] == res.data_ptr()
    assert calls[0][5:9] == (dproj.data_ptr(), pair.data_ptr(),
                             None if dc is None else dc.data_ptr(),
                             dh0.data_ptr())
    # w2 and the dc exchange only where there is a reset gate
    assert (calls[0][2] is None) == (calls[0][7] is None) == (kind == "mgru")


@pytest.mark.parametrize("h_dim,batch", [(40, 3), (1024, 128), (1024, 300),
                                         (2048, 4), (4240, 3)])
@pytest.mark.parametrize("kind", sorted(GATED_KINDS))
def test_gated_scan_is_handed_the_train_forward_plan(monkeypatch, kind,
                                                     h_dim, batch):
    """gated_scan runs the training forward's kernel body: one launch per
    row chunk of the same plan, the same operands and scratch in the same
    order, without the residuals, and a barrier count a launch."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda _: contextlib.nullcontext())
    monkeypatch.setattr(rnn_cuda, "_CAPACITY", {})
    t, gp = 3, GATED_KINDS[kind]
    rand, w1, w2, act = _gated_launch_case(kind, h_dim, batch, t)
    args = (rand(t, batch, gp * h_dim), w1, w2, rand(batch, h_dim))
    calls = {}

    def entry(name):
        def fn(*a):
            calls.setdefault(name, []).append(a)
            return 0
        return fn

    before = dict(kernels.launches)
    try:
        hs, res, h = rnn_cuda._gated_forward_launch(
            "gated_scan", gated_scan_plan, entry("scan"), _gated_query,
            *args, kind, act, None, with_res=False)
        assert res is None and hs.shape == (t, batch, h_dim)
        assert h.shape == (batch, h_dim) and h.dtype == torch.float32
        rnn_cuda._gated_train_forward_launch(entry("train"), _gated_query,
                                             *args, kind, act, None)
        assert kernels.launches["gated_scan"] == \
            before.get("gated_scan", 0) + 1
    finally:
        kernels.launches.clear()
        kernels.launches.update(before)
    plan = gated_scan_plan(h_dim, batch, _h100_gated)
    assert plan == gated_train_fwd_plan(h_dim, batch, _h100_gated)
    scan, train = calls["scan"], calls["train"]
    assert len(scan) == len(train) == len(plan.launches)
    for i, (row0, nrows) in enumerate(plan.launches):
        assert len(scan[i]) == len(rnn_cuda._GATED_SCAN_ARGTYPES)
        assert scan[i][-10:] == train[i][-10:]
        assert scan[i][-10:-5] == (t, batch, h_dim, row0, nrows)
        assert scan[i][:7] == scan[0][:7]            # the same tensors
        assert scan[i][7] - scan[0][7] == 4 * i      # one barrier a launch
    # the training forward's pointers with the residuals left out
    assert scan[0][0] == args[0].data_ptr()
    assert (scan[0][2] is None) == (scan[0][5] is None) == (kind == "mgru")


def _families():
    return {"lstm": ("lstm", True, 7, ("dz", 4)),
            "gru": ("gated", True, 4, ("pair", 2), ("dc", 1)),
            "mgru": ("gated", False, 4, ("pair", 2)),
            "peephole": ("peephole", True, 8, ("dz", 4))}


def _plan(name, h_dim):
    family, has_w2 = _families()[name][:2]
    return dw_plan(family, h_dim, has_w2)


def _outputs(name, h_dim):
    return {"lstm": [4 * h_dim], "gru": [2 * h_dim, h_dim],
            "mgru": [2 * h_dim],
            "peephole": [4 * h_dim, h_dim, h_dim, h_dim]}[name]


@pytest.mark.parametrize("batch", BS)
@pytest.mark.parametrize("h_dim", HS)
@pytest.mark.parametrize("name", ["lstm", "gru", "mgru", "peephole"])
def test_dw_plan_covers_every_output_once(name, h_dim, batch):
    plan = _plan(name, h_dim)
    assert (plan.tile_n, plan.rows, plan.stages) in DW_CONFIGS
    assert plan.smem_bytes <= SMEM_LIMIT
    assert [p.n for p in plan.problems] == _outputs(name, h_dim)
    cover = [np.zeros((h_dim, p.n), np.int64) for p in plan.problems]
    starts = [p.tile0 for p in plan.problems]
    assert starts[0] == 0 and starts == sorted(starts)
    for t in range(plan.tiles):
        k = max(i for i, s in enumerate(starts) if s <= t)
        p = plan.problems[k]
        local = t - p.tile0
        tiles_n = -(-p.n // plan.tile_n)
        i0 = (local // tiles_n) * DW_TILE_M
        j0 = (local % tiles_n) * plan.tile_n
        assert i0 < h_dim and j0 < p.n
        cover[k][i0:i0 + DW_TILE_M, j0:j0 + plan.tile_n] += 1
    assert all((c == 1).all() for c in cover)


def _dw_case(name, h_dim, batch, t_len=1):
    """Residuals and bf16 gradient operands of one backward, by name."""
    family, has_w2, width, *ops = _families()[name]
    rng = np.random.default_rng(h_dim * 10 + batch)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)

    res = bf16(t_len, batch, width * h_dim)
    return res, {op: bf16(t_len, batch, k * h_dim) for op, k in ops}


def _contract(plan, h_dim, res, operands):
    """dW of every problem from strided views of the flat operands, as the
    kernel addresses them."""
    m_rows = res.shape[0] * res.shape[1]
    flat = res.flatten()
    outs = []
    for p in plan.problems:
        a = torch.as_strided(flat, (m_rows, h_dim), (p.lda, 1),
                             p.a_col).float()
        if p.r_col is not None:
            r = torch.as_strided(flat, (m_rows, h_dim), (p.lda, 1),
                                 p.r_col).float()
            a = (r * a).to(torch.bfloat16).float()
        b = torch.as_strided(operands[p.b].flatten(), (m_rows, p.n),
                             (p.ldb, 1), p.b_col).float()
        outs.append(a.T @ b)
    return outs


@pytest.mark.parametrize("batch", BS)
@pytest.mark.parametrize("h_dim", HS)
@pytest.mark.parametrize("name", ["lstm", "gru", "mgru", "peephole"])
def test_dw_descriptors_address_the_reference_columns(name, h_dim, batch):
    plan = _plan(name, h_dim)
    res, operands = _dw_case(name, h_dim, batch)
    got = _contract(plan, h_dim, res, operands)
    if name == "lstm":
        want = [rnn_cuda.lstm_train_dw_reference(res, operands["dz"])]
    elif name == "peephole":
        want = list(rnn_cuda.peephole_train_dw_reference(res,
                                                         operands["dz"]))
    else:
        want = [w for w in rnn_cuda.gated_train_dw_reference(
            res, operands["pair"], operands.get("dc")) if w is not None]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_dw_plan_takes_wide_tiles_only_where_they_fill_the_card():
    assert _plan("lstm", 1024).tile_n == 256          # 128 wide tiles
    assert _plan("gru", 1024).stages == 3             # r takes a third
    assert _plan("mgru", 1024).tile_n == 128          # 64 wide: too few
    assert _plan("peephole", 1024).tile_n == 256
    assert all(_plan(n, 40).tile_n == 128
               for n in ("lstm", "gru", "mgru", "peephole"))
    with pytest.raises(ValueError, match="tiling"):
        dw_plan("lstm", 64, True, (64, 64, 4))


@pytest.mark.parametrize("name", ["lstm", "gru", "mgru", "peephole"])
def test_dw_launch_packs_the_descriptors(name):
    """The words handed to the C entry point: per problem the A, r and B
    addresses (base + 2 bytes a column), row strides, output, n, tile0."""
    h_dim, batch = 40, 3
    plan = _plan(name, h_dim)
    res, operands = _dw_case(name, h_dim, batch, t_len=2)
    outs = [torch.empty(h_dim, p.n) for p in plan.problems]
    seen = {}

    def entry(desc, count, m_rows, h, tile_n, rows, stages, stream):
        seen.update(words=[desc[i] for i in range(8 * count)], count=count,
                    m=m_rows, h=h, tiling=(tile_n, rows, stages))
        return 0

    before = dict(kernels.launches)
    try:
        rnn_cuda._dw_launch("test_dw", entry, plan, h_dim, res, operands,
                            outs, None)
        assert kernels.launches["test_dw"] == before.get("test_dw", 0) + 1
    finally:
        kernels.launches.clear()
        kernels.launches.update(before)
    assert seen["count"] == len(plan.problems)
    assert seen["m"] == 2 * batch and seen["h"] == h_dim
    assert seen["tiling"] == (plan.tile_n, plan.rows, plan.stages)
    base = res.data_ptr()
    for k, (p, out) in enumerate(zip(plan.problems, outs)):
        w = seen["words"][8 * k:8 * k + 8]
        assert w == [base + 2 * p.a_col, p.lda,
                     0 if p.r_col is None else base + 2 * p.r_col,
                     operands[p.b].data_ptr() + 2 * p.b_col, p.ldb,
                     out.data_ptr(), p.n, p.tile0]
