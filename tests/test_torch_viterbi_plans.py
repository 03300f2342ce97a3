"""Host-side layout of the Viterbi kernels' cluster route
(``decoder/viterbi_collapsed.py``: ``viterbi_cluster_plan``,
``cell_order``, ``cluster_records``,
``longest_first`` and the launch helpers ``_collapsed_launch`` and
``viterbi_cube._cube_launch``), on the CPU.

The kernels run only on the card; what they are handed is plain Python,
and is checked here, for the collapsed and the dense-cube geometry of
synthetic 4-, 9- and 48-phone images and of geometries too big for a
cluster: every (state, row, lane) cell is computed by exactly one thread
of one block of the cluster; each block's shared memory fits the card's
227 KB; the route is the cluster route with the smallest cluster
wherever a slice fits, and the device-memory route exactly where none
does; the state is in registers exactly where a warp owns one chunk and
the rows fit the unrolled steps, and the shared-memory size the plan
gives is the kernel's formula; the cell records hold each cell's
transitions and pdf ids where the kernel's warp reads them; and the
wrappers hand the kernel the plan's cluster size and state's home, the
records and the utterances longest first, or on the device-memory route
its scratch, counting the routes apart.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nnacousticmodeling_tpu_torch import kernels
from nnacousticmodeling_tpu_torch.decoder import viterbi_collapsed as vc
from nnacousticmodeling_tpu_torch.decoder import viterbi_cube as vcube
from nnacousticmodeling_tpu_torch.decoder.image import make_synthetic_image
from nnacousticmodeling_tpu_torch.decoder.viterbi import ViterbiDecoder
from nnacousticmodeling_tpu_torch.decoder.viterbi_collapsed import (
    CLUSTER_SIZES,
    LANE_CHUNK,
    MAX_WARPS,
    REG_STEPS,
    ROW_GROUPS,
    SMEM_LIMIT,
    ViterbiPlan,
    cell_order,
    cluster_records,
    cluster_smem_bytes,
    longest_first,
    registers_fit,
    viterbi_cluster_plan,
)

HEADER = (Path(vc.__file__).resolve().parent.parent / "csrc"
          / "viterbi_cluster.cuh")

_OBJS = {}


def _kernel_obj(num_phones, geometry):
    """The collapsed or the cube kernel's host object of a synthetic
    image (pdf-tied transitions; 48 phones: chip_smoke.py's 1909 pdfs)."""
    key = (num_phones, geometry)
    if key not in _OBJS:
        states = 1909 if num_phones == 48 else 3 * num_phones + 2
        img = make_synthetic_image(num_phones=num_phones, num_states=states,
                                   seed=num_phones, pdf_tied_transitions=True)
        dec = ViterbiDecoder(img, pip=5.0, lmw=1.5, device="cpu",
                             backend="auto" if geometry == "collapsed"
                             else "pallas")
        _OBJS[key] = (dec._collapsed_fwd if geometry == "collapsed"
                      else dec._pallas_fwd)
    return _OBJS[key]


def _lanes(obj):
    return obj.tps.shape[2]


def _cluster_cell_counts(plan: ViterbiPlan, ps: int) -> np.ndarray:
    """How many (block, thread) pairs of the cluster route compute each
    (row, lane) cell -- all three states of it -- walking the kernel's
    loops: block r's warp w takes the 8-lane chunks k = w, w + nwarps, ...
    of its slice, its thread of group g the rows g, g + 4, .... (ps,
    lanes) int array."""
    counts = np.zeros((ps, plan.cluster * plan.slice), np.int64)
    nwarps = plan.threads // 32
    for rank in range(plan.cluster):
        for tid in range(plan.threads):
            warp, lane = divmod(tid, 32)
            g, jj = divmod(lane, LANE_CHUNK)
            for k in range(warp, plan.slice // LANE_CHUNK, nwarps):
                j = rank * plan.slice + k * LANE_CHUNK + jj
                counts[g::ROW_GROUPS, j] += 1
    return counts


def _cuh_smem_bytes(ps, lanes, s, c, rs):
    """``smem_bytes`` of csrc/viterbi_cluster.cuh, its C expression read
    from the header and evaluated."""
    body = re.search(r"inline size_t smem_bytes\(int PS, int lanes, int S, "
                     r"int c, int rs\) \{(.*?)\n\}", HEADER.read_text(),
                     re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body).replace("(size_t)", "")
    env = dict(PS=ps, lanes=lanes, S=s, c=c, rs=rs,
               round4=lambda x: (x + 3) & ~3)
    env["w"] = eval(re.search(r"const int w = (.*?);", body).group(1)
                    .replace("/", "//"), {}, env)
    expr = " ".join(re.search(r"return (.*?);", body, re.S).group(1).split())
    return eval(expr.replace("rs ? 0 :", "0 if rs else"), {}, env)


def _fits(ps, lanes, s, c, limit=SMEM_LIMIT):
    w = lanes // c
    return (ps % ROW_GROUPS == 0 and lanes % c == 0 and w % LANE_CHUNK == 0
            and cluster_smem_bytes(ps, lanes, s, c) <= limit)


def test_layout_constants_mirror_the_kernel():
    text = HEADER.read_text()
    consts = dict(re.findall(r"constexpr (?:int|size_t) (\w+) = (\d+);",
                             text))
    assert int(consts["LANE_CHUNK"]) == LANE_CHUNK
    assert int(consts["ROW_GROUPS"]) == ROW_GROUPS
    assert int(consts["MAX_WARPS"]) == MAX_WARPS
    assert int(consts["MAX_CLUSTER"]) == max(CLUSTER_SIZES)
    assert int(consts["SMEM_LIMIT"]) == SMEM_LIMIT
    assert int(consts["REG_STEPS"]) == REG_STEPS
    assert LANE_CHUNK * ROW_GROUPS == 32


@pytest.mark.parametrize("geometry", ["collapsed", "cube"])
@pytest.mark.parametrize("num_phones", [4, 9, 48])
def test_plan_of_synthetic_images(num_phones, geometry):
    obj = _kernel_obj(num_phones, geometry)
    ps, lanes, s = obj.PS, _lanes(obj), obj.S
    # the cube kernel keeps its state in shared memory
    plan = viterbi_cluster_plan(ps, lanes, s,
                                registers=geometry == "collapsed")
    assert obj.plan == plan
    fitting = [c for c in CLUSTER_SIZES if _fits(ps, lanes, s, c)]
    if not fitting:
        assert plan == ViterbiPlan("global")
        assert not hasattr(obj, "records")
        return
    assert plan.route == "cluster" and plan.cluster == min(fitting)
    assert plan.slice * plan.cluster == lanes
    assert plan.registers == (geometry == "collapsed"
                              and registers_fit(ps, plan.slice))
    assert plan.smem_bytes == cluster_smem_bytes(ps, lanes, s, plan.cluster,
                                                 plan.registers)
    assert plan.smem_bytes == _cuh_smem_bytes(
        ps, lanes, s, plan.cluster, REG_STEPS if plan.registers else 0)
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.threads == 32 * min(plan.slice // LANE_CHUNK, MAX_WARPS)
    counts = _cluster_cell_counts(plan, ps)
    assert counts.shape == (ps, lanes) and (counts == 1).all()
    if plan.registers:
        # one chunk a warp, each thread's rows within the unrolled steps
        assert plan.threads // 32 == plan.slice // LANE_CHUNK
        assert ps // ROW_GROUPS <= REG_STEPS


def test_chip_smoke_image_takes_a_cluster_of_16():
    """The 48-phone 1909-pdf image: 2.65 MB of state an utterance, 144
    lanes x 48 rows x 3 states a block of 16; no (U, 3, PS, L) scratch.
    The collapsed kernel keeps it in its threads' registers (18 chunks for
    18 warps, 12 row steps a thread), with no state in shared memory; the
    cube kernel in shared memory."""
    for geometry in ("collapsed", "cube"):
        plan = _kernel_obj(48, geometry).plan
        registers = geometry == "collapsed"
        assert (plan.route, plan.cluster, plan.slice, plan.threads,
                plan.registers) == ("cluster", 16, 144, 576, registers)
        shared = vc._route("f", plan, "shared", (48, 2304, 1909))
        assert shared == ViterbiPlan("cluster", 16, 144, 576, 201184, False)
        assert shared.smem_bytes == (3 * 48 * 144 * 8 + 35296) == \
            _cuh_smem_bytes(48, 2304, 1909, 16, 0)
        if registers:
            assert plan.smem_bytes == (2 * (2304 + 48) * 4 + 2 * 144 * 4
                                       + 16 + 16 + 2 * 1912 * 4) == 35296
            assert plan.smem_bytes == _cuh_smem_bytes(48, 2304, 1909, 16,
                                                      REG_STEPS)
        else:
            assert plan == shared


@pytest.mark.parametrize("ps,lanes,s,why", [
    (8, 256, 30, "32 chunks a block of 1 for 18 warps"),
    (16, 2304, 1909, "a cluster of 8 fits first: 36 chunks for 18 warps"),
    (52, 128, 30, "13 row steps, beyond the 12 in registers"),
    (12, 128, 30, "3 row steps: no kernel is built for an odd count"),
])
def test_shared_memory_route_where_registers_do_not_fit(ps, lanes, s, why):
    plan = viterbi_cluster_plan(ps, lanes, s)
    assert plan.route == "cluster" and not plan.registers
    assert not registers_fit(ps, plan.slice)
    assert plan.smem_bytes == cluster_smem_bytes(ps, lanes, s, plan.cluster)
    assert plan.smem_bytes == _cuh_smem_bytes(ps, lanes, s, plan.cluster, 0)
    assert plan == viterbi_cluster_plan(ps, lanes, s, registers=False)


def test_odd_cube_takes_the_device_memory_route():
    """9 phones: B = 81 lanes, which no cluster splits into slices of a
    multiple of 8 lanes, while the collapsed geometry's 128 lanes do."""
    assert _kernel_obj(9, "cube").plan.route == "global"
    assert _kernel_obj(9, "collapsed").plan.route == "cluster"


@pytest.mark.parametrize("ps,lanes,s", [
    (64, 4096, 3000),     # a 64-phone cube: 393 KB of state a block of 16
    (48, 4608, 1909),     # twice the lanes of the 48-phone image
    (48, 2304, 40000),    # posterior rows that no block holds
    (6, 2304, 1909),      # rows not a multiple of the row groups
])
def test_too_big_for_a_cluster(ps, lanes, s):
    assert not any(_fits(ps, lanes, s, c) for c in CLUSTER_SIZES)
    assert viterbi_cluster_plan(ps, lanes, s) == ViterbiPlan("global")


def test_the_64_phone_cube_image_takes_the_device_memory_route():
    img = make_synthetic_image(num_phones=64, num_states=200, seed=3,
                               pdf_tied_transitions=True)
    cv = vcube.CubeViterbi(img, "abc", pip=5.0, lmw=1.5, device="cpu")
    assert (cv.PS, cv.B) == (64, 4096)
    assert cv.plan == ViterbiPlan("global")


@pytest.mark.parametrize("c", CLUSTER_SIZES)
def test_device_memory_route_exactly_where_no_cluster_fits(c):
    """With the limit just at a cluster size's need, that size (or a
    smaller one) is chosen; one byte below every fitting size's need,
    the device-memory route."""
    ps, lanes, s = 48, 2304, 1909
    need = cluster_smem_bytes(ps, lanes, s, c)
    plan = viterbi_cluster_plan(ps, lanes, s, smem_limit=need)
    assert plan.route == "cluster" and plan.cluster <= c
    assert plan.smem_bytes <= need
    smaller = [d for d in CLUSTER_SIZES if d < c]
    assert all(cluster_smem_bytes(ps, lanes, s, d) > need for d in smaller)
    least = min(cluster_smem_bytes(ps, lanes, s, d) for d in CLUSTER_SIZES)
    assert viterbi_cluster_plan(ps, lanes, s, smem_limit=least - 1) == \
        ViterbiPlan("global")


def test_cell_order_puts_a_warps_cells_together():
    ps, lanes = 8, 32
    x = np.arange(ps * lanes).reshape(ps, lanes)
    flat = cell_order(x)
    for a in range(ps):
        for j in range(lanes):
            i, g = divmod(a, ROW_GROUPS)
            k, jj = divmod(j, LANE_CHUNK)
            idx = (i * (lanes // LANE_CHUNK) + k) * 32 + g * LANE_CHUNK + jj
            assert flat[idx] == x[a, j]


@pytest.mark.parametrize("geometry", ["collapsed", "cube"])
@pytest.mark.parametrize("num_phones", [4, 48])
def test_records_hold_each_cells_tables(num_phones, geometry):
    obj = _kernel_obj(num_phones, geometry)
    ps, lanes = obj.PS, _lanes(obj)
    n = ps * lanes
    rec = obj.records.numpy()
    assert rec.dtype == np.int32 and rec.shape == (8 * n,)
    undo = lambda v: v.reshape(  # noqa: E731
        ps // ROW_GROUPS, lanes // LANE_CHUNK, ROW_GROUPS, LANE_CHUNK
    ).transpose(0, 2, 1, 3).reshape(ps, lanes)
    r12, r3, r0 = (rec[:4 * n].reshape(n, 4), rec[4 * n:6 * n].reshape(n, 2),
                   rec[6 * n:].reshape(n, 2))
    tps, pdf = obj.tps.numpy(), obj.pdf.numpy()
    f32 = lambda v: undo(np.ascontiguousarray(v).view(np.float32))  # noqa
    for col, plane in enumerate((1, 2, 3, 4)):
        np.testing.assert_array_equal(f32(r12[:, col]), tps[plane])
    np.testing.assert_array_equal(f32(r3[:, 0]), tps[5])
    np.testing.assert_array_equal(f32(r0[:, 0]), tps[0])
    hi = lambda v: undo(np.ascontiguousarray(v) >> 16)  # noqa: E731
    lo = lambda v: undo(np.ascontiguousarray(v) & 0xFFFF)  # noqa: E731
    np.testing.assert_array_equal(lo(r3[:, 1]), pdf[1])
    np.testing.assert_array_equal(hi(r3[:, 1].view(np.uint32)), pdf[2])
    np.testing.assert_array_equal(lo(r0[:, 1]), pdf[0])
    if geometry == "collapsed":
        bp = np.arange(lanes) % obj.Pp
        np.testing.assert_array_equal(hi(r0[:, 1]), obj.src.numpy()[:, bp])
        np.testing.assert_array_equal(undo(obj.lmq_cells.numpy()),
                                      obj.lmq.numpy()[:, bp])
    else:
        assert (hi(r0[:, 1]) == 0).all()


def test_records_refuse_ids_beyond_16_bits():
    pdf = np.zeros((3, 4, 8), np.int64)
    pdf[1, 2, 3] = 1 << 16
    with pytest.raises(vc.UnsupportedImage, match="16 bits"):
        cluster_records(pdf, np.zeros((6, 4, 8), np.float32))


def test_longest_first():
    lens = torch.tensor([3, 7, 0, 7, 1, 5], dtype=torch.int32)
    order = longest_first(lens)
    assert order.dtype == torch.int32
    assert order.tolist() == [1, 3, 5, 0, 4, 2]


class _FakeLib:
    """Entry points that record their arguments; the order (int32, U) is
    read through its pointer while the call lasts."""

    def __init__(self, u):
        self.calls = []
        self.u = u

    def __getattr__(self, name):
        def entry(*args):
            order = None
            if name.endswith("_cluster"):
                order = np.ctypeslib.as_array(
                    (ctypes.c_int32 * self.u).from_address(args[2])).copy()
            self.calls.append((name, args, order))
            return 0
        return entry


def _launch_case(geometry, num_phones=4):
    obj = _kernel_obj(num_phones, geometry)
    lens = torch.tensor([5, 9, 0, 9, 1], dtype=torch.int32)
    lp = torch.zeros((5, 9, obj.S))
    return obj, lp, lens


@pytest.mark.parametrize("geometry,route", [
    ("collapsed", None), ("collapsed", "shared"), ("cube", None)])
def test_wrapper_hands_the_kernel_the_plan_and_longest_first(geometry,
                                                             route):
    """The plan's cluster route (the 4-phone image's: the collapsed
    kernel's state in registers, the cube kernel's in shared memory), or
    the collapsed kernel's cluster route with the state in shared memory
    forced: the cluster size (and, to the collapsed kernel, the state's
    home) handed to the kernel, and the register route counted again as
    ``.registers``."""
    obj, lp, lens = _launch_case(geometry)
    launch = (vc._collapsed_launch if geometry == "collapsed"
              else vcube._cube_launch)
    argtypes = (vc._CLUSTER_ARGTYPES if geometry == "collapsed"
                else vcube._CLUSTER_ARGTYPES)
    assert obj.plan.registers == (geometry == "collapsed")
    plan = vc._route("t", obj.plan, route, (obj.PS, _lanes(obj), obj.S))
    assert plan.registers == (route is None and geometry == "collapsed")
    lib = _FakeLib(5)
    before = dict(kernels.launches)
    counters = [f"{geometry}_viterbi_forward{x}"
                for x in ("", ".registers", ".global")]
    try:
        packed, end = launch(obj, lp, lens, plan, lib, None)
        counted = [kernels.launches[n] - before.get(n, 0) for n in counters]
        assert counted == [1, int(plan.registers), 0]
    finally:
        kernels.launches.clear()
        kernels.launches.update(before)
    [(name, args, order)] = lib.calls
    assert name == f"{geometry}_viterbi_cluster"
    assert len(args) == len(argtypes)
    if geometry == "collapsed":
        assert args[-3] == plan.cluster == obj.plan.cluster
        assert args[-2] == int(plan.registers)
    else:
        assert args[-2] == plan.cluster == obj.plan.cluster
    assert plan.route == "cluster"
    assert order.tolist() == [1, 3, 0, 4, 2]
    assert args[0] == lp.data_ptr() and args[1] == lens.data_ptr()
    assert args[3] == obj.records.data_ptr()
    lanes = _lanes(obj)
    assert packed.shape == (5, 9, lanes) and packed.dtype == torch.int32
    assert end.shape == (5, 9, obj.P) and end.dtype == torch.float32
    assert packed.data_ptr() in args and end.data_ptr() in args
    # U, T, S, P, PS and the lanes follow the pointers
    first = argtypes.index(ctypes.c_int)
    assert args[first:first + 6] == (5, 9, obj.S, obj.P, obj.PS, lanes)


@pytest.mark.parametrize("geometry", ["collapsed", "cube"])
def test_wrapper_device_memory_route(geometry):
    obj, lp, lens = _launch_case(geometry)
    launch = (vc._collapsed_launch if geometry == "collapsed"
              else vcube._cube_launch)
    argtypes = (vc._ARGTYPES if geometry == "collapsed"
                else vcube._ARGTYPES)
    lib = _FakeLib(5)
    before = dict(kernels.launches)
    try:
        launch(obj, lp, lens, vc._route("t", obj.plan, "global"), lib, None)
        assert kernels.launches[f"{geometry}_viterbi_forward.global"] == \
            before.get(f"{geometry}_viterbi_forward.global", 0) + 1
        assert kernels.launches[f"{geometry}_viterbi_forward"] == \
            before.get(f"{geometry}_viterbi_forward", 0)
        assert kernels.launches[f"{geometry}_viterbi_forward.registers"] == \
            before.get(f"{geometry}_viterbi_forward.registers", 0)
    finally:
        kernels.launches.clear()
        kernels.launches.update(before)
    [(name, args, _)] = lib.calls
    assert name == f"{geometry}_viterbi_forward"
    assert len(args) == len(argtypes)
    assert args[0] == lp.data_ptr() and args[1] == lens.data_ptr()
    assert args[2] == obj.pdf.data_ptr() and args[3] == obj.tps.data_ptr()


def test_route_argument():
    plan = ViterbiPlan("cluster", 1, 128, 512, 1)
    assert vc._route("f", plan, None) is plan
    assert vc._route("f", plan, "global") == ViterbiPlan("global")
    with pytest.raises(ValueError, match="route"):
        vc._route("f", plan, "cluster")


def test_cube_wrapper_refuses_shared():
    """The cube kernel has one cluster route, its state in shared memory,
    so it takes no ``route="shared"``: refused before any tensor is
    read."""
    obj, lp, lens = _launch_case("cube")
    with pytest.raises(ValueError, match="None or 'global'"):
        vcube.cube_viterbi_forward(obj, lp, lens, route="shared")


def test_register_kernels_built_for_every_even_step_count():
    """csrc/viterbi_collapsed.cu builds a register-route kernel for each
    even count of row steps up to ``REG_STEPS``, which is where
    ``registers_fit`` sends a slice of one chunk a warp; each such plan
    keeps no state in shared memory."""
    src = (HEADER.parent / "viterbi_collapsed.cu").read_text()
    cases = re.findall(r"case (\d+): return "
                       r"collapsed_viterbi_cluster_kernel<(\d+)>;", src)
    assert all(a == b for a, b in cases)
    built = {int(a) for a, _ in cases}
    fit = {ps // ROW_GROUPS for ps in range(ROW_GROUPS, 100, ROW_GROUPS)
           if registers_fit(ps, 144)}
    assert built == {0} | fit == {0, 2, 4, 6, 8, 10, REG_STEPS}
    assert not registers_fit(48, 152)
    for rs in sorted(fit):
        plan = viterbi_cluster_plan(ROW_GROUPS * rs, 128, 30)
        assert plan.registers and plan.threads == 32 * 128 // LANE_CHUNK
        assert plan.smem_bytes == _cuh_smem_bytes(ROW_GROUPS * rs, 128, 30,
                                                  1, rs)


def test_route_argument_shared():
    """``"shared"``: the same cluster with its state in shared memory,
    for the kernels that have a register route (given their geometry);
    refused without a cluster to put it in, and by the scan kernel, whose
    state is in shared memory on its only cluster route."""
    geometry = (8, 128, 14)
    plan = viterbi_cluster_plan(*geometry)
    assert plan.registers
    shared = vc._route("f", plan, "shared", geometry)
    assert shared == ViterbiPlan("cluster", 1, 128, 512,
                                 cluster_smem_bytes(*geometry, 1), False)
    assert vc._route("f", shared, "shared", geometry) == shared
    with pytest.raises(ValueError, match="'shared'"):
        vc._route("f", ViterbiPlan("global"), "shared", geometry)
    with pytest.raises(ValueError, match="None or 'global'"):
        vc._route("f", plan, "shared")


def test_register_route_holds_its_frames():
    """The register route's 16-bit entry times (-1 to T - 2) hold up to
    ``REG_FRAMES`` frames, the header's limit; a longer decode takes the
    shared-memory route of the same cluster."""
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);",
                             HEADER.read_text()))
    assert int(consts["REG_FRAMES"]) == vc.REG_FRAMES == 2 ** 15 - 1
    geometry = (48, 2304, 1909)
    plan = viterbi_cluster_plan(*geometry)
    shared = viterbi_cluster_plan(*geometry, registers=False)
    for frames in (0, 1, 2046, vc.REG_FRAMES):
        assert vc._route("f", plan, None, geometry, frames) is plan
    assert vc._route("f", plan, None, geometry, vc.REG_FRAMES + 1) == shared
    assert vc._route("f", shared, None, geometry, 10 ** 6) is shared
