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
"""

import dataclasses

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
