"""A numpy transcription of the ``viterbi_backtrace`` kernel's hop, and
the host-side rules its wrapper applies (no JAX: the card tests import
``kernel_model`` and ``planted_walks`` from here).

``kernel_model`` walks as ``csrc/viterbi_backtrace.cu`` does: the pack
factor unpacked with a shift and a mask (``pack_shift``), the collapsed
walk's biphone carried as the pair (b, c) and moved to (q, b), ``tri``
built in 32-bit wrapping arithmetic, the range tests that end a walk
after the row that named an index outside its table, and the table each
route reads (the collapsed modes' int32 bi2lane; the lane map's shared
route reads the int16 copy, its global route the int32 table).
``test_torch_backtrace.py`` holds it bit-equal to the plain walk and to
the JAX decoder's walks on forward and adversarial rows. Here it is held
to walks planted by construction: each hop's entry written where the
walk will read it, the expected rows taken from the plan, not from a
walk. The plans reach what no forward makes: negative entries, q < 0,
q >= P (collapsed) or >= M (lane map), a ``tri`` past int32, a table or
end-map lane out of range, NaN and ties in the last end row, lengths 0,
1, 2 and T, pack factors 2048 to 8192; where every index stays in range
the plain walk must agree.
"""

import numpy as np
import pytest
import torch

from nnacousticmodeling_tpu_torch.decoder import viterbi_backtrace as vbt
from nnacousticmodeling_tpu_torch.decoder.viterbi import ViterbiDecoder
from nnacousticmodeling_tpu_torch.ops.rnn_cuda import SMEM_LIMIT


def _int32(x: int) -> int:
    """The low 32 bits of ``x`` as a signed int."""
    return ((x + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31


def _first_max(row: np.ndarray) -> int:
    """torch.argmax of a float32 row: NaN the largest, lowest index."""
    nan = np.isnan(row)
    return int(np.argmax(nan)) if nan.any() else int(np.argmax(row))


def kernel_model(tables, packed, end, lens, pack, route=None):
    """(segs (U, T, 3) int32, counts (U,) int64) as the kernel computes
    them on ``route`` (``backtrace_route``'s pick unless given)."""
    packed = np.asarray(packed, np.int32)
    end = np.asarray(end, np.float32)
    lens = np.asarray(lens)
    route = vbt.backtrace_route(tables) if route is None else route
    assert route in vbt.backtrace_routes(tables)
    shift = vbt.pack_shift(pack)
    mask = (1 << shift) - 1
    P = tables.num_phones
    end_map = tables.end_map32.cpu().numpy()
    M = tables.step_map32.numel()
    if route == "shared" and tables.mode == vbt.LANES:
        step = tables.step_map16.cpu().numpy()
        assert step.dtype == np.int16
    else:
        step = tables.step_map32.cpu().numpy()
        assert step.dtype == np.int32
    U, T, L = packed.shape
    segs = np.zeros((U, T, 3), np.int32)
    counts = np.zeros(U, np.int64)
    for u in range(U):
        n = min(int(lens[u]), T)
        if n <= 0:
            continue
        cur = int(end_map[_first_max(end[u, n - 1])])
        t, k = n - 1, 0

        def hop(lane):
            entry = int(packed[u, t, lane])
            return entry >> shift, (entry & mask) - 1

        if tables.mode == vbt.LANES:
            while 0 <= cur < L:
                q, t_new = hop(cur)
                segs[u, k] = (t_new + 1, t + 1, q)
                k += 1
                if t_new >= t or t_new < 0:
                    break
                t = t_new
                if not 0 <= q < M:
                    break
                cur = int(step[q])
        elif 0 <= cur < M:
            assert M == P * P
            b, c = divmod(cur, P)
            while True:
                lane = int(step[b * P + c])
                if not 0 <= lane < L:
                    break
                q, t_new = hop(lane)
                if tables.mode == vbt.COLLAPSED_BAC:
                    tri = ((b * P + q) * P + c) & 0xFFFFFFFF
                else:
                    tri = ((q * P + b) * P + c) & 0xFFFFFFFF
                segs[u, k] = (t_new + 1, t + 1, _int32(tri))
                k += 1
                if t_new >= t or t_new < 0:
                    break
                t = t_new
                if not 0 <= q < P:
                    break
                b, c = q, b
        counts[u] = k
    return segs, counts


# ---- walks planted by construction -----------------------------------
#: how a planted walk's last hop ends it
ENDINGS = ("guard", "start", "negative", "q_high", "q_huge", "lane_out")
#: endings whose every index stays in range (the plain walk agrees)
IN_RANGE = ("guard", "start")


def _tables(mode, P, L, rng, bad_lane=False):
    """Random tables: lane map (M = P**3 triphones -> lanes < L) or
    collapsed (P*P biphones -> lanes < L). With ``bad_lane`` the lane
    map's last triphone, or every biphone (P-1, b), names lane L + 3 (no
    end biphone is one of those)."""
    M = P ** 3 if mode == vbt.LANES else P * P
    step = rng.integers(0, L, M)
    if bad_lane:
        step[-1 if mode == vbt.LANES else slice((P - 1) * P, None)] = L + 3
    end = (rng.choice(L, P, replace=False) if mode == vbt.LANES
           else rng.choice((P - 1) * P, P, replace=False))
    return vbt.backtrace_tables(mode, P, torch.from_numpy(end),
                                torch.from_numpy(step))


def planted_walks(tables, pack, T, L, lens, endings, rng):
    """(packed, end, expected segs, expected counts): utterance u walks
    from its last end row's first max through hops planted in ``packed``
    (frames 1-3 apart, each next lane in range) and ends as
    ``endings[u]`` says; the rows expected are the plan's."""
    P = tables.num_phones
    step = tables.step_map.numpy()
    end_map = tables.end_map.numpy()
    M = step.size
    lanes_mode = tables.mode == vbt.LANES
    U = len(lens)
    packed = rng.integers(-2 ** 31, 2 ** 31, (U, T, L)).astype(np.int32)
    end = rng.choice(np.asarray([-3.0, -1.5, -1.5], np.float32),
                     size=(U, T, end_map.size))
    segs = np.zeros((U, T, 3), np.int32)
    counts = np.zeros(U, np.int64)
    good_q = np.flatnonzero(step < L) if lanes_mode else None
    for u, (n, how) in enumerate(zip(lens, endings)):
        if n <= 0:
            continue
        if u % 3 == 1:
            end[u, n - 1, rng.integers(0, end_map.size)] = np.nan
        cur = int(end_map[_first_max(end[u, n - 1])])
        b, c = divmod(cur, P)
        t, k = n - 1, 0
        while True:
            lane = cur if lanes_mode else int(step[b * P + c])
            assert 0 <= lane < L
            last = t <= 3 or rng.random() < 0.05
            # a predecessor whose lane is in range
            q = (int(rng.choice(good_q)) if lanes_mode else int(rng.choice(
                [a for a in range(P) if step[a * P + b] < L])))
            if not last:
                t_new = t - int(rng.integers(1, 4))
            elif how == "guard":
                t_new = t + int(rng.integers(0, 2))
            elif how == "start":
                t_new = -1
            elif how == "negative":
                t_new, q = max(t - 1, 0), -int(rng.integers(1, 4))
            elif how == "q_high":
                t_new, q = max(t - 1, 0), (M if lanes_mode else P)
            elif how == "q_huge":
                t_new, q = max(t - 1, 0), (2 ** 31 - 1) // pack
            else:                                        # "lane_out"
                t_new = max(t - 1, 0)
                if lanes_mode:
                    q = int(np.flatnonzero(step >= L)[0])
                else:
                    q = next(a for a in range(P) if step[a * P + b] >= L)
            entry = q * pack + t_new + 1
            assert -2 ** 31 <= entry < 2 ** 31 and 0 <= t_new + 1 < pack
            packed[u, t, lane] = entry
            if lanes_mode:
                tri = q
            elif tables.mode == vbt.COLLAPSED_BAC:
                tri = _int32((b * P + q) * P + c)
            else:
                tri = _int32((q * P + b) * P + c)
            segs[u, k] = (t_new + 1, t + 1, tri)
            k += 1
            if last or t_new < 0:
                break
            t = t_new
            if lanes_mode:
                cur = int(step[q])
            else:
                b, c = q, b
        counts[u] = k
    return packed, np.ascontiguousarray(end), segs, counts


def _case(mode, P, L, pack, T, seed, endings=ENDINGS):
    rng = np.random.default_rng(seed)
    tables = _tables(mode, P, L, rng, bad_lane=True)
    lens = [T, 0, 1, 2] + [int(n) for n in rng.integers(3, T + 1, 8)]
    ends = [endings[u % len(endings)] for u in range(len(lens))]
    packed, end, segs, counts = planted_walks(tables, pack, T, L, lens, ends,
                                              rng)
    return tables, packed, end, np.asarray(lens, np.int32), ends, segs, counts


MODES = {"lanes": vbt.LANES, "bac": vbt.COLLAPSED_BAC,
         "abc": vbt.COLLAPSED_ABC}


#: every (mode, route) the kernel runs
MODE_ROUTES = [("abc", "shared"), ("bac", "shared"), ("lanes", "shared"),
               ("lanes", "global")]


@pytest.mark.parametrize("pack", [2048, 4096, 8192])
@pytest.mark.parametrize("mode,route", MODE_ROUTES)
def test_model_follows_planted_walks(mode, route, pack):
    """Every ending, every route, three pack factors: the model's segs
    (padding included) and counts are the plan's."""
    tables, packed, end, lens, ends, segs, counts = _case(
        MODES[mode], 4, 10, pack, 40, 7 * pack + len(mode))
    got = kernel_model(tables, packed, end, lens, pack, route)
    np.testing.assert_array_equal(got[1], counts)
    np.testing.assert_array_equal(got[0], segs)
    assert counts[1] == 0 and counts[2] == 1 and (counts[[0, 3]] >= 1).all()


@pytest.mark.parametrize("mode", ["bac", "abc"])
def test_model_wraps_tri_past_int32(mode):
    """P=48 and q = (2**31-1) // pack: the triphone id passes int32 in
    'abc' order and wraps to the low 32 bits, as the plain version's
    int64 -> int32 cast does."""
    tables, packed, end, lens, ends, segs, counts = _case(
        MODES[mode], 48, 64, 2048, 30, 11, endings=("q_huge",))
    got = kernel_model(tables, packed, end, lens, 2048)
    np.testing.assert_array_equal(got[0], segs)
    np.testing.assert_array_equal(got[1], counts)
    last = segs[np.arange(len(lens)), np.maximum(counts - 1, 0), 2]
    if mode == "abc":
        assert (last[counts > 0] < 0).any()
    want = torch.tensor([(2 ** 31 - 1) // 2048 * 48 * 48 + 47 * 48 + 47])
    assert int(want.to(torch.int32)) == _int32(int(want))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_plain_walk_agrees_where_indices_stay_in_range(mode):
    """Walks ending by the frame guard or at frame 0 (lengths 0, 1, 2, T,
    NaN and ties in the last end rows): the plain walk, the model and
    the plan agree; the plain walk raises on the other endings, which is
    why the kernel's range tests are held to the plan."""
    tables, packed, end, lens, ends, segs, counts = _case(
        MODES[mode], 5, 12, 2048, 33, 3 + len(mode), endings=IN_RANGE)
    want = vbt.viterbi_backtrace_reference(
        tables, torch.from_numpy(packed), torch.from_numpy(end),
        torch.from_numpy(lens), 2048)
    np.testing.assert_array_equal(want[0].numpy(), segs)
    np.testing.assert_array_equal(want[1].numpy(), counts)
    for route in vbt.backtrace_routes(tables):
        got = kernel_model(tables, packed, end, lens, 2048, route)
        np.testing.assert_array_equal(got[0], segs)
        np.testing.assert_array_equal(got[1], counts)


def test_end_map_lane_out_of_range_walks_nothing():
    """A first lane (lane map) or biphone (collapsed) outside its table:
    count 0, the row stays zero."""
    rng = np.random.default_rng(5)
    for mode, bad in ((vbt.LANES, 10), (vbt.COLLAPSED_ABC, 16),
                      (vbt.COLLAPSED_BAC, -1)):
        tables = _tables(mode, 4, 10, rng)
        end_map = tables.end_map.clone()
        end_map[:] = bad
        tables = vbt.backtrace_tables(mode, 4, end_map, tables.step_map)
        packed = rng.integers(0, 2 ** 20, (2, 6, 10)).astype(np.int32)
        end = rng.standard_normal((2, 6, 4)).astype(np.float32)
        segs, counts = kernel_model(tables, packed, end, [6, 3], 2048)
        assert not counts.any() and not segs.any()


def test_pack_shift_takes_powers_of_two_only():
    """The wrapper's pack test: every pack ``_grow_pack`` makes (frames 0
    to 2**20) is a power of two and gives its log2; 3000, 0, negatives
    and 2**31 are refused."""
    t = 0
    while t <= 2 ** 20:
        pack = ViterbiDecoder._grow_pack(t)
        assert vbt.pack_shift(pack) == pack.bit_length() - 1
        assert 1 << vbt.pack_shift(pack) == pack
        t = 2 * t + 1
    for bad in (3000, 0, -2048, 2 ** 31, 6144):
        with pytest.raises(ValueError, match="power of two"):
            vbt.pack_shift(bad)


def test_route_rule_by_table_size():
    """The collapsed tables (P*P int32) always in shared memory; the lane
    map's int16 copy there where it fits (216 KB at P=48), the global
    route beside it; the global route alone for a lane map whose values
    do not fit int16 or whose table does not fit (P=49)."""
    rng = np.random.default_rng(0)
    for mode in (vbt.COLLAPSED_BAC, vbt.COLLAPSED_ABC):
        tables = _tables(mode, 48, 2304, rng)
        assert tables.step_map16 is None
        assert vbt.shared_table_bytes(tables) == 48 * 4 + 48 * 48 * 4
        assert vbt.backtrace_route(tables) == "shared"
        assert vbt.backtrace_routes(tables) == ("shared",)
    lanes48 = _tables(vbt.LANES, 48, 2304, rng)
    assert lanes48.step_map16.dtype == torch.int16
    assert torch.equal(lanes48.step_map16.long(), lanes48.step_map)
    assert vbt.shared_table_bytes(lanes48) == 48 * 4 + 2 * 48 ** 3
    assert vbt.backtrace_route(lanes48) == "shared"
    assert vbt.backtrace_routes(lanes48) == ("shared", "global")
    lanes49 = _tables(vbt.LANES, 49, 2401, rng)
    assert vbt.shared_table_bytes(lanes49) > SMEM_LIMIT
    assert vbt.backtrace_route(lanes49) == "global"
    assert vbt.backtrace_routes(lanes49) == ("global",)
    wide = vbt.backtrace_tables(vbt.LANES, 4, torch.arange(4),
                                torch.full((64,), 2 ** 15))
    assert wide.step_map16 is None and vbt.backtrace_route(wide) == "global"
    assert vbt.backtrace_routes(wide) == ("global",)
