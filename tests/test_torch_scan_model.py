"""A numpy transcription of the ``viterbi_scan_forward`` kernel, held
bit-equal to ``jax.vmap`` of the JAX decoder's ``_forward_scan`` and to
the port's two plain twins (``_forward_scan_cube``,
``_forward_scan_general``).

``kernel_model`` runs as ``csrc/viterbi_scan.cu`` does, vectorised over
the threads that own the biphones: the tables in the kernel's slot-major
(F, B) layout (``viterbi_scan.ScanTables``), each frame a loop over the F
fan-in slots in which only slots below a biphone's ``count`` update, the
first max in slot order with the first NaN beating every number, the
padding export (NEG_INF, id -1 and the last triphone's new entry time,
published from ``last_slot``) where a row has padding and every valid
slot scores below NEG_INF, the empty row's (NEG_INF, id 0 and triphone
0's, from ``zero_slot``), the score row kept raw and clamped where it
is read with the previous frame's beam threshold (a NaN-propagating max),
every sum a float32 add. Cases: ties, NaN frames, empty fan-in rows,
-inf posteriors (padding exports), a beam, lmw 1 and 1.5, T = 1 and T =
2100 (pack 4096). This holds the kernel's design where ``nvcc`` is
absent; the card tests hold the kernel to the plain twins.

``cluster_model`` transcribes the kernel's cluster route the same way:
c blocks, each owning a slice of W biphones (B / c rounded up to 8) and
keeping their slots' state in its own arrays, indexed as the kernel
indexes shared memory; each slot's tables read from the 32-byte records
(``viterbi_scan.scan_records``) at the kernel's record index; thread (g,
jj) of a warp's chunk walking slots g, g + 4, ... of its biphone; pass 1
(states 2 and 1, the export, the slice written into the block's own copy
of the row, the warp maxima, the two published entry times), the
butterfly over the four threads of a biphone, pass 2 (state 0 from the
block's copy of the previous row), then the exchange: each block gathers
the peers' slices, takes the threshold from every block's maxima and
fetches the two entry times from their owners' slots. It is held to the
same references on the same cases at the plan's cluster size and at 2
and 4 blocks, and at the 48-phone image's 16 blocks to the port's
general twin; ``scan_cluster_plan``'s routes are checked on the host.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnacousticmodeling_tpu.decoder.image import make_synthetic_image
from nnacousticmodeling_tpu.decoder.viterbi import (
    ViterbiDecoder as JaxDecoder,
)
from nnacousticmodeling_tpu_torch.decoder import viterbi_scan
from nnacousticmodeling_tpu_torch.decoder.viterbi import ViterbiDecoder
from nnacousticmodeling_tpu_torch.decoder.viterbi_collapsed import (
    CLUSTER_SIZES,
    MAX_WARPS,
    SMEM_LIMIT,
    ViterbiPlan,
)

from test_torch_viterbi import _to_bac

NEG_INF = np.float32(-1e20)


def kernel_model(tables, lp, pack, stats=None):
    """(packed (U, T, B) int32, end (U, T, P) float32) as the kernel
    computes them; ``stats["padded"]`` (where given) counts the padding
    exports."""
    count = tables.count.numpy()
    idx = tables.idx.numpy()
    tpa = tables.tpa.numpy()
    tpb = tables.tpb.numpy()
    fan = tables.fan.numpy()
    lm, p0 = tables.lm.numpy(), tables.p0.numpy()
    end_idxs = tables.end_idxs.numpy()
    F, B = fan.shape
    threads, bpt = viterbi_scan.launch_shape(B)
    assert threads * bpt >= B and threads % 32 == 0
    assert bpt <= viterbi_scan.MAX_BIPHONES_A_THREAD
    z_slot, z_b = divmod(tables.zero_slot, B)
    l_slot, l_b = divmod(tables.last_slot, B)
    assert fan[z_slot, z_b] == 0 and z_slot < count[z_b]
    assert fan[l_slot, l_b] == tables.num_triphones - 1
    lp = np.asarray(lp, np.float32)
    U, T, _ = lp.shape
    pip = np.float32(tables.pip)
    beam = None if tables.beam is None else np.float32(tables.beam)
    q = np.full((3, F, U, B), NEG_INF, np.float32)       # pp 0-2 a slot
    tt = np.zeros((3, F, U, B), np.int32)
    packed = np.zeros((U, T, B), np.int32)
    end = np.zeros((U, T, len(end_idxs)), np.float32)
    p = np.broadcast_to(p0, (U, B)).copy()
    thr = None
    bs = np.arange(B)
    for k in range(T):
        obs = lp[:, k]
        best = np.zeros((U, B), np.float32)
        col = np.zeros((U, B), np.int64)
        bt = np.zeros((U, B), np.int32)
        tt0 = ttl = None
        for j in range(F):
            act = j < count                                  # (B,)
            ix, ta, tb = idx[j], tpa[j], tpb[j]
            pin = p[:, ix[:, 3]]
            if thr is not None:
                pin = np.where(pin >= thr[:, None], pin, NEG_INF)
            pin = pin + pip
            q0, q1, q2 = q[:, j]
            t0, t1, t2 = tt[:, j]
            stay, go = q2 + ta[:, 2], q1 + tb[:, 0]
            take = go > stay
            n2 = np.where(take, go, stay) + obs[:, ix[:, 2]]
            u2 = np.where(take, t1, t2)
            stay, go = q1 + ta[:, 1], q0 + ta[:, 3]
            take = go > stay
            n1 = np.where(take, go, stay) + obs[:, ix[:, 1]]
            u1 = np.where(take, t0, t1)
            stay = q0 + ta[:, 0]
            take = pin > stay
            n0 = np.where(take, pin, stay) + obs[:, ix[:, 0]]
            u0 = np.where(take, np.int32(k - 1), t0)
            q[:, j] = np.where(act, np.stack([n0, n1, n2]), q[:, j])
            tt[:, j] = np.where(act, np.stack([u0, u1, u2]), tt[:, j])
            if j == z_slot:
                tt0 = u2[:, z_b]
            if j == l_slot:
                ttl = u2[:, l_b]
            out = n2 + tb[:, 1]
            better = np.where(np.isnan(out), ~np.isnan(best), out > best)
            upd = act & (better | (j == 0))
            best = np.where(upd, out, best)
            col = np.where(upd, j, col)
            bt = np.where(upd, u2, bt)
        empty = np.broadcast_to(count == 0, best.shape)
        padded = ((count > 0) & (count < F) & ~np.isnan(best)
                  & (best < NEG_INF))
        mx = np.where(padded | empty, NEG_INF, best)
        if stats is not None:
            stats["padded"] = stats.get("padded", 0) + int(padded.sum())
            stats["empty"] = stats.get("empty", 0) + int(empty.sum())
        tri = fan[col, bs] * np.int32(pack) + bt + 1
        tri = np.where(padded, ttl[:, None] + 1 - np.int32(pack), tri)
        packed[:, k] = np.where(empty, tt0[:, None] + 1, tri)
        v = mx + lm
        if beam is not None:
            thr = np.max(v, axis=1) - beam                   # NaN propagates
        e = v[:, end_idxs]
        if beam is not None:
            e = np.where(e >= thr[:, None], e, NEG_INF)
        end[:, k] = e
        p = v
    return packed, end


def _first_max_takes(out, best):
    return np.where(np.isnan(out), ~np.isnan(best), out > best)


def _partner_wins(ob, oc, best, col):
    return np.where(np.isnan(ob), ~np.isnan(best) | (oc < col),
                    ~np.isnan(best) & ((ob > best)
                                       | ((ob == best) & (oc < col))))


INT_MIN = np.int32(-2 ** 31)


def _max_key(v):
    """The kernel's order-preserving int key of a float (NaN the largest)."""
    i = np.asarray(v, np.float32).view(np.int32)
    return np.where(np.isnan(v), np.int32(2 ** 31 - 1),
                    np.where(i >= 0, i, i ^ np.int32(0x7FFFFFFF)))


def _key_value(k):
    k = np.asarray(k, np.int32)
    bits = np.where(k == 2 ** 31 - 1, k, np.where(k >= 0, k, k ^ 0x7FFFFFFF))
    return bits.astype(np.int32).view(np.float32)


def cluster_model(tables, lp, pack, c):
    """(packed, end) as the cluster route computes them with ``c`` blocks
    an utterance (``csrc/viterbi_scan.cu``, ``viterbi_scan_cluster``)."""
    count = tables.count.numpy()
    fan, lm = tables.fan.numpy(), tables.lm.numpy()
    p0, end_idxs = tables.p0.numpy(), tables.end_idxs.numpy()
    rec = tables.records.numpy()
    F, B = fan.shape
    S, P = tables.num_states, tables.num_phones
    lp = np.asarray(lp, np.float32)
    U, T, _ = lp.shape
    pip = np.float32(tables.pip)
    beam = None if tables.beam is None else np.float32(tables.beam)
    # the block's layout
    W = viterbi_scan.scan_slice(B, c)
    RW = c * W
    steps = -(-F // 4)
    nch = W // 8
    nkb = -(-B // 8)
    nwarps = min(nch, MAX_WARPS)
    nt = 32 * nwarps
    plane = steps * nch * 32
    n = steps * 4 * nkb * 8
    assert rec.shape == (8 * n,)
    rec12 = rec[:4 * n].reshape(n, 4)
    rec3 = rec[4 * n:6 * n].reshape(n, 2)
    rec0 = rec[6 * n:].reshape(n, 2)
    f32 = lambda x: x.view(np.float32)  # noqa: E731
    # thread coordinates, shape (c, nch, 4, 8): block, chunk, g, jj
    r_, kc, g, jj = np.meshgrid(np.arange(c), np.arange(nch), np.arange(4),
                                np.arange(8), indexing="ij")
    lane = g * 8 + jj
    b = (r_ * nch + kc) * 8 + jj
    inb = b < B
    cnt = np.where(inb, count[np.minimum(b, B - 1)], 0)
    bsafe = np.minimum(b, B - 1)
    z_rank = (tables.zero_slot % B) // W
    l_rank = (tables.last_slot % B) // W
    # shared memory of each block
    st_s = np.full((U, c, 3, plane), NEG_INF, np.float32)
    st_t = np.zeros((U, c, 3, plane), np.int32)
    rows = np.zeros((U, c, 2, RW), np.float32)
    rows[:, :, 1, :B] = p0
    row_max = np.full((U, c, 2), INT_MIN, np.int32)
    pub = np.zeros((U, c, 2, 2), np.int32)
    packed = np.zeros((U, T, B), np.int32)
    end = np.zeros((U, T, P), np.float32)
    thr = None
    ux = np.arange(U)[:, None, None, None, None]

    def slot_tables(i):
        j = i * 4 + g
        act = j < cnt
        e = np.where(act, ((i * nkb + r_ * nch + kc) << 5) + lane, 0)
        si = ((i * nch + kc) << 5) + lane
        return j, act, e, si

    for k in range(T):
        cur, nxt = k & 1, (k & 1) ^ 1
        obs = lp[:, k]
        ob_of = lambda ids: obs[ux, ids]  # noqa: E731
        # ---- pass 1 ----
        best = np.full((U,) + b.shape, -np.inf, np.float32)
        col = np.full((U,) + b.shape, F, np.int64)
        bt = np.zeros((U,) + b.shape, np.int32)
        for i in range(steps):
            j, act, e, si = slot_tables(i)
            r4, r3 = rec12[e], rec3[e]
            q0, q1, q2 = (st_s[:, r_, q, si] for q in range(3))
            t0, t1, t2 = (st_t[:, r_, q, si] for q in range(3))
            pdf1 = r3[..., 1] & 0xFFFF
            pdf2 = r3[..., 1].view(np.uint32) >> 16
            stay, go = q2 + f32(r4[..., 1]), q1 + f32(r4[..., 3])
            take = go > stay
            n2 = np.where(take, go, stay) + ob_of(pdf2)
            u2 = np.where(take, t1, t2)
            stay, go = q1 + f32(r4[..., 0]), q0 + f32(r4[..., 2])
            take = go > stay
            n1 = np.where(take, go, stay) + ob_of(pdf1)
            u1 = np.where(take, t0, t1)
            st_s[:, r_, 1, si] = np.where(act, n1, q1)
            st_s[:, r_, 2, si] = np.where(act, n2, q2)
            st_t[:, r_, 1, si] = np.where(act, u1, t1)
            st_t[:, r_, 2, si] = np.where(act, u2, t2)
            slot = j * B + b
            for q, which in ((0, tables.zero_slot), (1, tables.last_slot)):
                at = act & (slot == which)
                if at.any():
                    rr = r_[at][0]
                    pub[:, rr, cur, q] = u2[:, at][:, 0]
            out = n2 + f32(r3[..., 0])
            upd = act & ((i == 0) | _first_max_takes(out, best))
            best = np.where(upd, out, best)
            col = np.where(upd, j, col)
            bt = np.where(upd, u2, bt)
        for off in (1, 2):                      # lanes xor 8, xor 16
            partner = np.arange(4) ^ off
            ob, oc, ot = (x[:, :, :, partner] for x in (best, col, bt))
            win = _partner_wins(ob, oc, best, col)
            best = np.where(win, ob, best)
            col = np.where(win, oc, col)
            bt = np.where(win, ot, bt)
        # g == 0 lanes: (U, c, nch, 8)
        best, col, bt = best[:, :, :, 0], col[:, :, :, 0], bt[:, :, :, 0]
        b0, c0, ok = b[:, :, 0], cnt[:, :, 0], inb[:, :, 0]
        empty = np.broadcast_to(ok & (c0 == 0), best.shape)
        padded = (ok & (c0 > 0) & (c0 < F) & ~np.isnan(best)
                  & (best < NEG_INF))
        mx = np.where(empty | padded, NEG_INF, best)
        key = fan[np.minimum(col, F - 1), np.minimum(b0, B - 1)] * \
            np.int32(pack) + bt + 1
        v = mx + lm[np.minimum(b0, B - 1)]
        for rr in range(c):
            sel = ok[rr]
            bb = b0[rr][sel]
            packed[:, k, bb] = key[:, rr][:, sel]
            rows[:, rr, cur, bb] = v[:, rr][:, sel]
            kw = np.where(ok[rr], _max_key(v[:, rr]), INT_MIN)
            for w in range(nwarps):                  # atomicMax a warp
                local = kw[:, w::nwarps].reshape(U, -1).max(axis=1)
                row_max[:, rr, cur] = np.maximum(row_max[:, rr, cur], local)
        # ---- pass 2 ----
        for i in range(steps):
            j, act, e, si = slot_tables(i)
            r0 = rec0[e]
            q0, t0 = st_s[:, r_, 0, si], st_t[:, r_, 0, si]
            pin = rows[ux, r_, nxt, r0[..., 1] >> 16]
            if thr is not None:
                pin = np.where(pin >= thr[:, r_], pin, NEG_INF)
            pin = pin + pip
            stay = q0 + f32(r0[..., 0])
            take = pin > stay
            n0 = np.where(take, pin, stay) + ob_of(r0[..., 1] & 0xFFFF)
            u0 = np.where(take, np.int32(k - 1), t0)
            st_s[:, r_, 0, si] = np.where(act, n0, q0)
            st_t[:, r_, 0, si] = np.where(act, u0, t0)
        # ---- the exchange ----
        for rr in range(c):
            for peer in range(c):
                if peer != rr:
                    sl = slice(peer * W, (peer + 1) * W)
                    rows[:, rr, cur, sl] = rows[:, peer, cur, sl]
        got_z, got_l = pub[:, z_rank, cur, 0], pub[:, l_rank, cur, 1]
        if beam is not None:
            m = _key_value(row_max[:, :, cur].max(axis=1))
            thr = np.broadcast_to((m - beam)[:, None], (U, c)).copy()
        row_max[:, :, nxt] = INT_MIN
        for rr in range(c):
            bb = b0[rr][ok[rr]]
            packed[:, k, bb] = np.where(
                padded[:, rr][:, ok[rr]], (got_l + 1 - np.int32(pack))[:, None],
                np.where(empty[:, rr][:, ok[rr]], (got_z + 1)[:, None],
                         packed[:, k, bb]))
        owner = (np.arange(P) // nt) % c
        e_val = rows[:, owner, cur, end_idxs]               # (U, P)
        if beam is not None:
            e_val = np.where(e_val >= thr[:, owner], e_val, NEG_INF)
        end[:, k] = e_val
    return packed, end


def _with_empty_rows(img, drop):
    """``img`` without the triphones that feed the biphones ``drop``:
    their fan-in rows are empty; CSR rebuilt in ascending triphone id."""
    keep = ~np.isin(img.biphone_out, drop)
    ids = np.flatnonzero(keep)
    bi_out = img.biphone_out[keep]
    counts = np.bincount(bi_out, minlength=img.num_biphones)
    offsets = np.zeros(img.num_biphones + 1, np.int32)
    np.cumsum(counts, out=offsets[1:])
    return dataclasses.replace(
        img, num_triphones=len(ids), biphone_in=img.biphone_in[keep],
        biphone_out=bi_out, state_idxs=img.state_idxs[keep],
        tp_selfloop=img.tp_selfloop[keep],
        tp_transition=img.tp_transition[keep], out_offsets=offsets,
        out_values=np.argsort(bi_out, kind="stable").astype(np.int32),
        phone_names=[img.phone_names[i] for i in ids]).validate()


IMAGES = {
    "untied": lambda: make_synthetic_image(num_phones=4, seed=0),
    "untied_bac": lambda: _to_bac(make_synthetic_image(num_phones=3,
                                                       seed=3)),
    "tied": lambda: make_synthetic_image(num_phones=4, seed=4,
                                         pdf_tied_transitions=True),
    "partial": lambda: make_synthetic_image(num_phones=3, seed=2,
                                            full_context=False),
    "empty_rows": lambda: _with_empty_rows(make_synthetic_image(
        num_phones=4, seed=6, full_context=False), [1, 6, 11]),
}


def _lp(kind, img, u, t, seed):
    rng = np.random.default_rng(seed)
    s = img.num_states
    lp = np.log(rng.dirichlet(np.ones(s), size=(u, t))).astype(np.float32)
    if kind == "ties":                  # every pdf equal: scores tie
        lp[:] = np.float32(-np.log(s))
    elif kind == "nan":                 # a diverged model's frames
        lp[0, min(4, t - 1)] = np.nan
        lp[-1, t // 2] = np.nan
    elif kind == "nan_partial":         # NaN in half the pdfs of a frame
        lp[-1, t // 2, : s // 2] = np.nan
    elif kind == "neginf":              # log 0: scores below NEG_INF
        lp[:, :, : (2 * s) // 3] = -np.inf
    return lp


# posteriors where some but not all pdfs of a frame are NaN or -inf: the
# JAX cube twin expands them with a one-hot contraction (0 * inf and
# 0 * NaN are NaN), so its (center, state) groups holding one turn NaN
# where the gather of its general twin, of the Pallas kernels and of the
# port keeps the values apart (test_jax_cube_twin_smears_non_finite_pdfs)
NON_FINITE_PDFS = ("nan_partial", "neginf")


def _jax_twin(img, kw, lp, general):
    """``jax.vmap`` of the JAX ``_forward_scan``: its general twin
    (``_cube_order`` set to None) or, on a cube, its cube twin."""
    dec = JaxDecoder(img, backend="xla", **kw)
    if general:
        dec._cube_order = None
    return [np.asarray(a) for a in
            jax.vmap(dec._forward_scan)(jnp.asarray(lp))]


CASES = [
    # (image, posteriors, beam, lmw, U, T)
    ("untied", "ties", None, 1.0, 2, 9),
    ("tied", "ties", 2.0, 1.5, 2, 9),
    ("partial", "ties", None, 1.5, 2, 9),
    ("untied", "nan", None, 1.5, 2, 9),
    ("untied", "nan", 2.0, 1.5, 2, 9),
    ("untied_bac", "nan", 2.0, 1.0, 3, 8),
    ("partial", "nan", 2.0, 1.5, 2, 9),
    ("untied", "nan_partial", None, 1.5, 2, 9),
    ("partial", "nan_partial", 2.0, 1.5, 2, 9),
    ("empty_rows", "dirichlet", None, 1.5, 3, 11),
    ("empty_rows", "dirichlet", 2.0, 1.0, 3, 11),
    ("empty_rows", "nan", 2.0, 1.5, 2, 9),
    ("partial", "neginf", None, 1.5, 2, 7),
    ("empty_rows", "neginf", 2.0, 1.5, 2, 7),
    ("tied", "neginf", None, 1.5, 2, 7),
    ("untied", "dirichlet", 2.0, 1.5, 3, 1),
    ("partial", "dirichlet", None, 1.0, 2, 1),
]


def _check(name, kind, beam, lmw, u, t, seed, stats=None):
    img = IMAGES[name]()
    lp = _lp(kind, img, u, t, seed)
    kw = dict(pip=5.0, lmw=lmw, beam=beam)
    port = ViterbiDecoder(img, backend="xla", device="cpu", **kw)
    pack = port._time_pack_for(t)
    got = kernel_model(port._scan, lp, pack, stats)
    assert port._scan.plan.route == "cluster"
    for c in sorted({port._scan.plan.cluster, 2, 4}):
        cl = cluster_model(port._scan, lp, pack, c)
        np.testing.assert_array_equal(cl[0], got[0])
        assert np.array_equal(cl[1], got[1], equal_nan=True)
    refs = [_jax_twin(img, kw, lp, general=True)]
    if port._cube_order is not None and kind not in NON_FINITE_PDFS:
        refs.append(_jax_twin(img, kw, lp, general=False))
    lp_t = torch.from_numpy(lp)
    twins = [port._forward_scan_general(lp_t)]
    if port._cube_order is not None:
        twins.append(port._forward_scan_cube(lp_t, port._cube_order))
    for ref in refs + [[a.numpy() for a in tw] for tw in twins]:
        np.testing.assert_array_equal(got[0], ref[0])
        assert np.array_equal(got[1], ref[1], equal_nan=True)
    return port, got


@pytest.mark.parametrize("name,kind,beam,lmw,u,t", CASES)
def test_model_bit_equal_to_jax_and_both_twins(name, kind, beam, lmw, u, t):
    stats = {}
    port, _ = _check(name, kind, beam, lmw, u, t, seed=len(name) + t,
                     stats=stats)
    if kind == "neginf" and port._cube_order is None:
        assert stats["padded"] > 0
    if name == "empty_rows":
        assert stats["empty"] == 3 * u * t
    if name == "empty_rows":
        assert (port._scan.count.numpy() == 0).sum() == 3


def test_model_padding_exports_take_triphone_zero():
    """-inf posteriors put every valid slot of some rows below NEG_INF:
    those rows export NEG_INF + lm and pack the padding id -1 with the
    last triphone's entry time, the twins' ``best_i = fanin[b, col]`` over
    a padding column."""
    stats = {}
    port, (packed, end) = _check("partial", "neginf", None, 1.5, 2, 7,
                                 seed=3, stats=stats)
    assert stats["padded"] > 0 and stats["empty"] == 0
    assert (packed < 0).any()


def test_model_long_utterance_pack_4096():
    """T = 2100 frames: pack 4096, entry times past 2047 packed beside
    the triphone id."""
    port, (packed, _) = _check("partial", "dirichlet", 2.0, 1.5, 1, 2100,
                               seed=21)
    assert port._time_pack_for(2100) == 4096
    assert int((packed % 4096).max()) > 2048


def test_tables_follow_dense_fanin():
    img = IMAGES["empty_rows"]()
    port = ViterbiDecoder(img, pip=5.0, lmw=1.5, device="cpu")
    t = port._scan
    fanin = img.dense_fanin()
    assert t.fan.shape == fanin.T.shape
    np.testing.assert_array_equal(t.count.numpy(), (fanin >= 0).sum(1))
    valid = (fanin >= 0).T
    np.testing.assert_array_equal(t.fan.numpy()[valid], fanin.T[valid])
    np.testing.assert_array_equal(t.idx.numpy()[..., 3][valid],
                                  img.biphone_in[fanin.T[valid]])
    np.testing.assert_array_equal(t.idx.numpy()[..., :3][valid],
                                  img.state_idxs[fanin.T[valid]])
    np.testing.assert_array_equal(t.lm.numpy(), port._lm.numpy())
    np.testing.assert_array_equal(t.p0.numpy(), port._p0.numpy())
    j, b = divmod(t.zero_slot, t.num_biphones)
    assert fanin[b, j] == 0


def test_tables_mark_fanin_that_is_not_a_partition():
    """An image whose fan-in rows list a triphone twice (and leave
    another out) gets ``zero_slot = -1``, which the wrapper refuses."""
    img = make_synthetic_image(num_phones=3, seed=2, full_context=False)
    values = img.out_values.copy()
    b = int(np.argmax(np.diff(img.out_offsets) >= 2))
    lo = img.out_offsets[b]
    values[lo + 1] = values[lo]
    bad = dataclasses.replace(img, out_values=values)
    port = ViterbiDecoder(bad, pip=5.0, device="cpu")
    assert port._scan.zero_slot == -1


@pytest.mark.parametrize("b", [1, 9, 32, 1024, 1025, 2304, 4096, 32768])
def test_launch_shape(b):
    threads, bpt = viterbi_scan.launch_shape(b)
    assert threads % 32 == 0 and threads <= viterbi_scan.MAX_THREADS
    assert threads * bpt >= b > (threads - 32) * bpt or b <= 32
    assert bpt == -(-b // 1024)
    if b == 2304:
        assert (threads, bpt) == (768, 3)


@pytest.mark.parametrize("kind", NON_FINITE_PDFS)
def test_jax_cube_twin_smears_non_finite_pdfs(kind):
    """Where a frame's posteriors are NaN or -inf for some pdfs only, the
    JAX cube twin's one-hot expansion (``_cube_obs``) gives other bits
    than its own general twin; the port's twins and kernel follow the
    gather (the general twin, the Pallas kernels)."""
    img = IMAGES["untied"]()
    lp = _lp(kind, img, 2, 9, seed=5)
    kw = dict(pip=5.0, lmw=1.5, beam=None)
    general = _jax_twin(img, kw, lp, general=True)
    cube = _jax_twin(img, kw, lp, general=False)
    assert not np.array_equal(general[0], cube[0])
    port = ViterbiDecoder(img, backend="xla", device="cpu", **kw)
    got = port._forward_scan_cube(torch.from_numpy(lp), port._cube_order)
    np.testing.assert_array_equal(got[0].numpy(), general[0])


@pytest.mark.parametrize("full_context", [True, False])
def test_cluster_model_at_48_phones_16_blocks(full_context):
    """chip_smoke.py phase 23's images (48 phones, 1909 pdfs: the untied
    cube and its full_context=False twin) take 16 blocks of 144 biphones;
    the model at that layout, on an all-NaN, a half-NaN and a -inf frame
    (padding exports on the non-cube image, whose last triphone's owner
    is the last block), without and with a beam, bit-equal to the port's
    general twin (held to JAX on the cases above)."""
    img = make_synthetic_image(num_phones=48, num_states=1909,
                               full_context=full_context)
    rng = np.random.default_rng(48)
    lp = np.log(rng.dirichlet(np.ones(1909), size=(2, 10))).astype(np.float32)
    lp[:, 5:8, :1900] = -np.inf
    lp[0, 8] = np.nan
    lp[1, 9, :950] = np.nan
    for beam in (None, 8.0):
        port = ViterbiDecoder(img, pip=20.0, lmw=1.0, beam=beam,
                              backend="xla", device="cpu")
        plan = port._scan.plan
        assert (plan.route, plan.cluster, plan.slice, plan.threads) == (
            "cluster", 16, 144, 576)
        got = cluster_model(port._scan, lp, port._time_pack_for(10), 16)
        want = port._forward_scan_general(torch.from_numpy(lp))
        np.testing.assert_array_equal(got[0], want[0].numpy())
        assert np.array_equal(got[1], want[1].numpy(), equal_nan=True)
        if not full_context:
            last_b = port._scan.last_slot % port._scan.num_biphones
            assert last_b // plan.slice == 15
            assert (got[0] < 0).any()        # padding exports


def _slot_owners(f, b, c):
    """How many (block, thread, step) triples of the cluster route update
    each (slot, biphone), walking the kernel's loops: block r's warp w
    takes chunks k = w, w + nwarps, ... of its slice, thread (g, jj) of a
    chunk the slots g, g + 4, ... of biphone (r * W / 8 + k) * 8 + jj."""
    w = viterbi_scan.scan_slice(b, c)
    nwarps = min(w // 8, MAX_WARPS)
    counts = np.zeros((f, b), np.int64)
    for r in range(c):
        for warp in range(nwarps):
            for k in range(warp, w // 8, nwarps):
                for g in range(4):
                    for jj in range(8):
                        bi = (r * (w // 8) + k) * 8 + jj
                        if bi < b:
                            counts[g:f:4, bi] += 1
    return counts


@pytest.mark.parametrize("f,b,s,c,slice_,threads", [
    (48, 2304, 1909, 16, 144, 576),     # chip_smoke.py's untied image
    (42, 2304, 1909, 16, 144, 576),     # its full_context=False twin
    (4, 16, 26, 1, 16, 64),             # 4 phones
    (3, 9, 20, 1, 16, 64),              # 3 phones: a ragged chunk
    (48, 400, 1909, 4, 104, 416),       # 20 phones: slices past B
])
def test_scan_cluster_plan(f, b, s, c, slice_, threads):
    plan = viterbi_scan.scan_cluster_plan(f, b, s)
    assert plan == ViterbiPlan("cluster", c, slice_, threads,
                               viterbi_scan.scan_cluster_smem_bytes(f, b, s,
                                                                    c))
    assert plan.smem_bytes <= SMEM_LIMIT
    smaller = [x for x in CLUSTER_SIZES if x < c]
    assert all(viterbi_scan.scan_cluster_smem_bytes(f, b, s, x) > SMEM_LIMIT
               for x in smaller)
    assert (_slot_owners(f, b, c) == 1).all()


@pytest.mark.parametrize("f,b,s", [
    (48, 2304, 70000),      # pdf ids past 16 bits
    (4, 40000, 26),         # in-biphones past 15 bits
    (200, 2304, 1909),      # no 16-block slice holds 200 slots a biphone
    (84, 4096, 1909),       # a 64-phone cube
])
def test_scan_plan_takes_the_device_memory_route(f, b, s):
    assert viterbi_scan.scan_cluster_plan(f, b, s) == ViterbiPlan("global")


def test_scan_plan_smallest_cluster_that_fits():
    """A smaller limit moves the plan to more blocks, and a limit no
    cluster meets to the device-memory route."""
    f, b, s = 4, 16, 26
    limit = viterbi_scan.scan_cluster_smem_bytes(f, b, s, 2)
    assert viterbi_scan.scan_cluster_plan(f, b, s, limit).cluster == 2
    assert (viterbi_scan.scan_cluster_plan(f, b, s, limit - 1)
            == ViterbiPlan("global"))
    assert (_slot_owners(f, b, 4) == 1).all()


def test_scan_layout_constants_mirror_the_kernel():
    from pathlib import Path
    text = (Path(viterbi_scan.__file__).resolve().parent.parent / "csrc"
            / "viterbi_scan.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", text))
    assert int(consts["CHUNK"]) == 8 == viterbi_scan.LANE_CHUNK
    assert int(consts["SLOT_GROUPS"]) == viterbi_scan.SLOT_GROUPS
    assert (int(consts["MAX_CHUNKS_A_WARP"])
            == viterbi_scan.MAX_CHUNKS_A_WARP)
    assert "S > (1 << 16) || B > (1 << 15)" in text
    assert (viterbi_scan.MAX_PDFS, viterbi_scan.MAX_BIPHONES) == (
        1 << 16, 1 << 15)


def test_scan_records_hold_each_slots_tables():
    """Each slot's record fields, read at the kernel's record index, are
    its transitions, pdf ids and in-biphone."""
    port = ViterbiDecoder(IMAGES["empty_rows"](), pip=5.0, device="cpu")
    t = port._scan
    F, B = t.width, t.num_biphones
    rec = t.records.numpy()
    nkb, steps = -(-B // 8), -(-F // 4)
    n = steps * 4 * nkb * 8
    assert rec.shape == (8 * n,) and rec.dtype == np.int32
    idx, tpa, tpb = t.idx.numpy(), t.tpa.numpy(), t.tpb.numpy()
    for j in range(F):
        for b in range(B):
            e = (((j // 4) * nkb + b // 8) << 5) + (j % 4) * 8 + b % 8
            r4 = rec[4 * e:4 * e + 4].view(np.float32)
            r3 = rec[4 * n + 2 * e:4 * n + 2 * e + 2]
            r0 = rec[6 * n + 2 * e:6 * n + 2 * e + 2]
            np.testing.assert_array_equal(
                r4, [tpa[j, b, 1], tpa[j, b, 2], tpa[j, b, 3], tpb[j, b, 0]])
            assert r3[:1].view(np.float32)[0] == tpb[j, b, 1]
            assert r0[:1].view(np.float32)[0] == tpa[j, b, 0]
            assert (r3[1] & 0xFFFF, int(r3[1].view(np.uint32)) >> 16) == (
                idx[j, b, 1], idx[j, b, 2])
            assert (r0[1] & 0xFFFF, r0[1] >> 16) == (idx[j, b, 0],
                                                     idx[j, b, 3])


class _FakeScanLib:
    """The kernel library's two launch entry points, recording calls."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("route", [None, "global"])
def test_scan_wrapper_hands_the_kernel_its_route(route):
    """The cluster route gets the plan's cluster size and the records, the
    device-memory route its scratch and launch shape; each is counted
    under its own name."""
    from nnacousticmodeling_tpu_torch import kernels
    from nnacousticmodeling_tpu_torch.decoder.viterbi_collapsed import (
        _route)
    port = ViterbiDecoder(IMAGES["partial"](), pip=5.0, beam=2.0,
                          device="cpu")
    t = port._scan
    lp = torch.zeros((3, 7, t.num_states))
    packed = torch.empty((3, 7, t.num_biphones), dtype=torch.int32)
    end = torch.empty((3, 7, t.num_phones))
    plan = _route("f", t.plan, route)
    lib = _FakeScanLib()
    before = dict(kernels.launches)
    try:
        viterbi_scan._scan_launch(t, lp, 2048, plan, lib, None, packed, end)
        counted = {k: v - before.get(k, 0)
                   for k, v in kernels.launches.items()
                   if v != before.get(k, 0)}
    finally:
        kernels.launches.clear()
        kernels.launches.update(before)
    [(name, args)] = lib.calls
    dims = (3, 7, t.num_states, t.num_biphones, t.width, t.num_phones,
            t.zero_slot, t.last_slot, 2048)
    if route is None:
        assert name == "viterbi_scan_cluster"
        assert counted == {"viterbi_scan_forward": 1}
        assert len(args) == len(viterbi_scan._CLUSTER_ARGTYPES)
        assert args[1] == t.records.data_ptr()
        assert args[9:19] == dims + (t.plan.cluster,)
    else:
        assert name == "viterbi_scan_forward"
        assert counted == {"viterbi_scan_forward.global": 1}
        assert len(args) == len(viterbi_scan._ARGTYPES)
        assert args[1] == t.idx.data_ptr()
        assert args[13:24] == dims + viterbi_scan.launch_shape(
            t.num_biphones)
    assert args[-4:-1] == (t.pip, 2.0, 1)
    assert packed.data_ptr() in args and end.data_ptr() in args
    with pytest.raises(ValueError, match="route"):
        viterbi_scan.viterbi_scan_forward(t, lp, 2048, route="cluster")
