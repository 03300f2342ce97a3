"""The port's CUDA kernels against their plain PyTorch versions, at test
sizes, on the card. Marked ``cuda``; without a card every test skips.
Run on a machine with one: ``python -m pytest tests/test_torch_cuda.py
-m cuda -q``.

Tolerances as in ``test_torch_lstm.py`` for the recurrence (bf16 ``h``
rounding after sums in another order); the Viterbi forwards are bit-equal
on every route (the plan's cluster route, its state in registers where
the image allows, the cluster route with the state in shared memory
forced with ``route="shared"``, and the device-memory route forced with
``route="global"``), and a refused cluster launch raises.
``lstm_scan`` (one persistent launch, tensor-core sums) gives the same
bits on every call. The LSTM training forward runs ``lstm_scan``'s
kernel code (csrc/lstm_persistent.cuh) and is bit-equal to it. Its
residuals are bf16 roundings of values within the recurrence tolerance
of the plain version, so they may differ by that plus one bf16 ulp (rtol
2**-7). The backward, given the same residuals, differs from its plain
version only by the order of its float32 sums (and the bf16 roundings of
dz those may flip): 1e-3 of each tensor's largest value; a second call
gives the same bits. The three dW contractions (one tensor-core GEMM) are held
to ``DW_RTOL`` of max |dW|, chip_smoke.py's bound.
The gated kernels are held to the same tolerances, each relative to the
largest value of its tensor (the relu candidate of MGRU is unbounded);
their training forward and the ``gated_scan`` kernel run one persistent
kernel body and are bit-equal, and each training kernel gives the same
bits on a second call. So are the peephole kernels, likewise. Where a wide case's bf16 hs
is compared, a value may round to the other neighbouring bf16 after
float32 sums in another order: one bf16 ulp (rtol RES_RTOL) is allowed
beside BF16_ATOL, as chip_smoke.py allows it; the peephole backward's
wide cases hold dh0 and dW to
the plain products of the kernel's own bf16 dz, and to the plain version
within limits set from the card's readings (see WIDE_DW_RTOL). The
dense-cube Viterbi forward is bit-equal to its plain version; the fbank
kernel (an FFT where the plain version takes dense DFT products) is
within 1e-3 of the plain ``fbank`` in the log domain, its two entries
(waveform, frames) bit-equal, and on a wide-range waveform no farther
from a float64 twin than the plain version, plus 1e-4. The decoder's
device callables (``decode_arrays_fn``, ``decode_fn``) run under sync
debug mode "error" and give the CPU decoder's segments.
"""

import numpy as np
import pytest
import torch

from nnacousticmodeling_tpu_torch import kernels
from nnacousticmodeling_tpu_torch.decoder.image import make_synthetic_image
from nnacousticmodeling_tpu_torch.decoder.viterbi import ViterbiDecoder
from nnacousticmodeling_tpu_torch.decoder.viterbi_collapsed import (
    collapsed_viterbi_reference,
)
from nnacousticmodeling_tpu_torch.decoder.viterbi_cube import (
    cube_viterbi_forward,
    cube_viterbi_reference,
)
from nnacousticmodeling_tpu_torch.ops import ctc_cuda, features
from nnacousticmodeling_tpu_torch.ops.rnn_cuda import (
    gated_scan,
    gated_scan_reference,
    gated_scan_train,
    gated_train_backward,
    gated_train_backward_reference,
    gated_train_dw,
    gated_train_dw_reference,
    gated_train_forward,
    gated_train_forward_reference,
    lstm_scan,
    lstm_scan_reference,
    lstm_scan_train,
    lstm_train_backward,
    lstm_train_backward_reference,
    lstm_train_dw,
    lstm_train_dw_reference,
    lstm_train_forward,
    lstm_train_forward_reference,
    peephole_scan,
    peephole_scan_reference,
    peephole_scan_train,
    peephole_train_backward,
    peephole_train_backward_reference,
    peephole_train_dw,
    peephole_train_dw_reference,
    peephole_train_forward,
    peephole_train_forward_reference,
)

pytestmark = pytest.mark.cuda

BF16_ATOL = 2e-3
RES_RTOL = 2.0 ** -7
BWD_RTOL = 1e-3
DW_RTOL = 3e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _scan_case(t, b, h, dtype, device):
    g = torch.Generator().manual_seed(t * 100 + b + h)
    proj = (torch.randn(t, b, 4 * h, generator=g) * 0.5).to(dtype)
    wh = torch.randn(h, 4 * h, generator=g) * min(0.1, 2.0 / h ** 0.5)
    c0 = torch.randn(b, h, generator=g) * 0.1
    h0 = torch.randn(b, h, generator=g) * 0.1
    return [x.to(device) for x in (proj, wh, c0, h0)]


# (4, 128, 1024): the serving width, W_h resident in shared memory;
# (3, 4, 2048): W_h streamed from L2; (1, 1, 40): one step, one row
SCAN_SIZES = [(5, 4, 32), (13, 3, 40), (8, 33, 64), (4, 128, 1024),
              (3, 4, 2048), (1, 1, 40)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,h", SCAN_SIZES)
def test_lstm_scan_kernel_matches_plain(cuda, t, b, h, dtype):
    args = _scan_case(t, b, h, dtype, cuda)
    before = kernels.launches["lstm_scan"]
    (ck, hk), hsk = lstm_scan(*args)
    torch.cuda.synchronize()
    assert kernels.launches["lstm_scan"] == before + 1
    (cr, hr), hsr = lstm_scan_reference(*args)
    assert hsk.dtype == dtype and hsk.shape == (t, b, h)
    torch.testing.assert_close(hsk.float(), hsr.float(), rtol=0,
                               atol=BF16_ATOL)
    torch.testing.assert_close(ck, cr, rtol=0, atol=BF16_ATOL)
    torch.testing.assert_close(hk, hr, rtol=0, atol=BF16_ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,h", [(13, 33, 40), (4, 128, 1024),
                                   (3, 4, 2048)])
def test_lstm_scan_kernel_repeats_bit_for_bit(cuda, t, b, h, dtype):
    args = _scan_case(t, b, h, dtype, cuda)
    (c1, h1), hs1 = lstm_scan(*args)
    (c2, h2), hs2 = lstm_scan(*args)
    torch.cuda.synchronize()
    assert torch.equal(hs1, hs2) and torch.equal(c1, c2)
    assert torch.equal(h1, h2)


def test_lstm_scan_kernel_row_chunks(cuda):
    """A batch beyond one co-resident grid goes through the kernel in row
    chunks of lstm_scan_plan, still one counted call."""
    args = _scan_case(3, 300, 1024, torch.float32, cuda)
    before = kernels.launches["lstm_scan"]
    (ck, hk), hsk = lstm_scan(*args)
    torch.cuda.synchronize()
    assert kernels.launches["lstm_scan"] == before + 1
    (cr, hr), hsr = lstm_scan_reference(*args)
    torch.testing.assert_close(hsk, hsr, rtol=0, atol=BF16_ATOL)
    torch.testing.assert_close(ck, cr, rtol=0, atol=BF16_ATOL)


def _dw_case(family, t, b, h, device):
    """Residuals and bf16 gradients of one training backward's dW."""
    g = torch.Generator().manual_seed(t * 1000 + b * 10 + h)
    width = {"lstm": 7, "gated": 4, "peephole": 8}[family]
    res = torch.rand(t, b, width * h, generator=g).to(torch.bfloat16)
    if family == "gated":
        ops = (torch.randn(t, b, 2 * h, generator=g),
               torch.randn(t, b, h, generator=g))
    else:
        ops = (torch.randn(t, b, 4 * h, generator=g),)
    return [x.to(device, torch.bfloat16) for x in (res, *ops)]


# 36: rows of 7*36 / 4*36 / 8*36 elements are no multiple of 16 bytes, so
# the operands arrive by cp.async, not TMA
@pytest.mark.parametrize("h", [36, 40, 1024])
@pytest.mark.parametrize("family", ["lstm", "gated", "peephole"])
def test_dw_kernels_match_plain(cuda, family, h):
    fn, ref = {"lstm": (lstm_train_dw, lstm_train_dw_reference),
               "gated": (gated_train_dw, gated_train_dw_reference),
               "peephole": (peephole_train_dw,
                            peephole_train_dw_reference)}[family]
    args = _dw_case(family, 3, 33, h, cuda)
    name = fn.__name__
    before = kernels.launches[name]
    got = fn(*args)
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = ref(*args)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for k, w in zip(got, want):
        assert k.dtype == torch.float32 and k.shape == w.shape
        torch.testing.assert_close(k, w, rtol=0,
                                   atol=DW_RTOL * float(w.abs().max()))
    again = fn(*args)
    again = again if isinstance(again, tuple) else (again,)
    assert all(torch.equal(a, k) for a, k in zip(again, got))


def _viterbi_image(num_phones, ends="regular"):
    import dataclasses
    states = 1909 if num_phones == 48 else 3 * num_phones + 2
    img = make_synthetic_image(num_phones=num_phones, num_states=states,
                               seed=num_phones, pdf_tied_transitions=True)
    if ends == "irregular":
        P = num_phones
        img = dataclasses.replace(img, end_idxs=np.array(
            [p * P + (p + 1) % P for p in range(P)], np.int32))
    return img


def _viterbi_kernel_case(cuda, obj, forward, reference, capacity, route,
                         name, seed):
    """``forward`` (the kernel wrapper) on ``route`` against ``reference``
    within lengths, with more utterances than the card holds clusters at
    once (waves) and lengths 0, 1 and the batch's T among them; a second
    call bit-identical; only ``name`` (the route's counter) counted, and
    ``name.registers`` beside it on the register route; the cluster route
    allocates no (U, 3, PS, lanes) scratch. Returns the posteriors and
    lengths (numpy)."""
    from nnacousticmodeling_tpu_torch.decoder import viterbi_collapsed as vc
    rng = np.random.default_rng(seed)
    t = 23
    plan = vc._route("case", obj.plan, route,
                     (obj.PS, obj.tps.shape[2], obj.S))
    cluster = plan.route == "cluster"
    registers = plan.registers
    u = capacity(obj) + 3 if cluster else 5
    lens = rng.integers(0, t + 1, u).astype(np.int32)
    lens[:3] = [0, 1, t]
    lp = np.log(rng.dirichlet(np.ones(obj.S), size=(u, t))).astype(
        np.float32)
    lp_t = torch.from_numpy(lp).to(cuda)
    lens_t = torch.from_numpy(lens).to(cuda)
    before = dict(kernels.launches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    packed, end = forward(obj, lp_t, lens_t, route=route)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    again = forward(obj, lp_t, lens_t, route=route)
    torch.cuda.synchronize()
    counted = {k: v - before.get(k, 0) for k, v in kernels.launches.items()
               if v != before.get(k, 0)}
    assert counted == ({name: 2, f"{name}.registers": 2} if registers
                       else {name: 2})
    lanes = obj.tps.shape[2]
    scratch = u * 3 * obj.PS * lanes * 8
    outputs = u * t * (lanes + obj.P) * 4
    assert (peak - outputs < scratch) == cluster
    want_packed, want_end = reference(obj, lp_t, lens_t)
    for i, n in enumerate(lens):
        assert torch.equal(packed[i, :n], want_packed[i, :n])
        assert torch.equal(end[i, :n], want_end[i, :n])
        assert torch.equal(again[0][i, :n], packed[i, :n])
        assert torch.equal(again[1][i, :n], end[i, :n])
    return lp, lens


@pytest.mark.parametrize("route", [None, "shared", "global"])
@pytest.mark.parametrize("beam", [None, 2.0])
@pytest.mark.parametrize("num_phones", [4, 9, 48])
def test_collapsed_viterbi_kernel_bit_equal(cuda, num_phones, beam, route):
    """Every route (the plan's: the state in registers, or for 9 phones,
    256 lanes, 32 chunks for 18 warps, in shared memory; the state in
    shared memory and the device-memory route forced) bit-equal to the
    plain version; segments equal to the CPU decoder's."""
    from nnacousticmodeling_tpu_torch.decoder import viterbi_collapsed as vc
    img = _viterbi_image(num_phones)
    dec = ViterbiDecoder(img, pip=5.0, lmw=1.5, beam=beam, device=cuda)
    ck = dec._collapsed_fwd
    assert ck.plan.route == "cluster"
    assert ck.plan.registers == (num_phones != 9)
    assert ck.plan.cluster == (16 if num_phones == 48 else 1)
    name = ("collapsed_viterbi_forward.global" if route == "global"
            else "collapsed_viterbi_forward")
    lp, lens = _viterbi_kernel_case(
        cuda, ck, vc.collapsed_viterbi_forward,
        collapsed_viterbi_reference, vc.collapsed_cluster_capacity, route,
        name, num_phones)
    cpu = ViterbiDecoder(img, pip=5.0, lmw=1.5, beam=beam, device="cpu")
    before = dict(kernels.launches)
    got = [r.segments for r in dec.decode_batch(lp, lens)]
    assert kernels.launches["collapsed_viterbi_forward"] == \
        before.get("collapsed_viterbi_forward", 0) + 1
    assert kernels.launches["collapsed_viterbi_forward.registers"] == \
        before.get("collapsed_viterbi_forward.registers", 0) + \
        ck.plan.registers
    assert got == [r.segments for r in cpu.decode_batch(lp, lens)]


@pytest.mark.parametrize("route", [None, "global"])
@pytest.mark.parametrize("beam", [None, 2.0])
@pytest.mark.parametrize("ends", ["regular", "irregular"])
@pytest.mark.parametrize("num_phones", [8, 9, 48])
def test_cube_viterbi_kernel_bit_equal(cuda, num_phones, ends, beam, route):
    """Both routes bit-equal to the plain version (8 and 48 phones: the
    plan's cluster route, the state in shared memory; 9 phones: 81 lanes,
    the plan's device-memory route either way); segments equal to the CPU
    decoder's and the scan twins', which launch the scan kernel and the
    backtrace kernel once each."""
    from nnacousticmodeling_tpu_torch.decoder import viterbi_cube as vcube
    img = _viterbi_image(num_phones, ends)
    dec = ViterbiDecoder(img, pip=5.0, lmw=1.5, beam=beam, backend="pallas",
                         device=cuda)
    cv = dec._pallas_fwd
    assert cv.plan.route == ("global" if num_phones == 9 else "cluster")
    assert not cv.plan.registers
    on_cluster = route is None and cv.plan.route == "cluster"
    name = ("cube_viterbi_forward" if on_cluster
            else "cube_viterbi_forward.global")
    lp, lens = _viterbi_kernel_case(
        cuda, cv, cube_viterbi_forward, cube_viterbi_reference,
        vcube.cube_cluster_capacity, route, name, 11 + num_phones)
    cpu = ViterbiDecoder(img, pip=5.0, lmw=1.5, beam=beam, backend="pallas",
                         device="cpu")
    want = [r.segments for r in cpu.decode_batch(lp, lens)]
    assert [r.segments for r in dec.decode_batch(lp, lens)] == want
    xla = ViterbiDecoder(img, pip=5.0, lmw=1.5, beam=beam, backend="xla",
                         device=cuda)
    before = dict(kernels.launches)
    assert [r.segments for r in xla.decode_batch(lp, lens)] == want
    counted = {k: v - before.get(k, 0) for k, v in kernels.launches.items()
               if v != before.get(k, 0)}
    assert counted == {"viterbi_scan_forward": 1, "viterbi_backtrace": 1}


def _nan_probe(cuda, num_phones=8):
    """The NaN rows of the collapsed and cube kernels' repair: 3
    utterances of 12 Dirichlet frames (seed 3) with an all-NaN frame and
    a frame NaN in half its pdfs, on the 8-phone pdf-tied image."""
    img = _viterbi_image(num_phones)
    rng = np.random.default_rng(3)
    lp = np.log(rng.dirichlet(np.ones(img.num_states), size=(3, 12))
                ).astype(np.float32)
    lp[0, 4] = np.nan
    lp[1, 6, :13] = np.nan
    lens = torch.full((3,), 12, dtype=torch.int32, device=cuda)
    return img, torch.from_numpy(lp).to(cuda), lens


@pytest.mark.parametrize("beam", [None, 2.0])
@pytest.mark.parametrize("kind,route", [
    ("collapsed", None), ("collapsed", "shared"), ("collapsed", "global"),
    ("cube", None), ("cube", "global"), ("cube9", None), ("cube9", "global"),
    ("cube12", None), ("cube12", "global")])
def test_viterbi_kernels_follow_plain_on_nan_rows(cuda, kind, beam, route):
    """Where a column's max is NaN no row matches it (the TPU kernels'
    jnp.max): the collapsed key 2**31 - 1, the cube export row P with pad
    row P's entry time ("cube9": 9 phones, rows padded to 16, the
    device-memory route either way; "cube12": 12 phones, rows padded to
    16, on both routes); the beam's row max propagates NaN. Both kernels,
    every route (the collapsed kernel's plan: its state in registers;
    its cluster with the state in shared memory forced): packed rows
    equal and end scores equal (NaN where NaN) to the plain versions."""
    from nnacousticmodeling_tpu_torch.decoder import viterbi_collapsed as vc
    phones = {"cube9": 9, "cube12": 12}.get(kind, 8)
    img, lp, lens = _nan_probe(cuda, phones)
    kind = kind[:4] if kind.startswith("cube") else kind
    dec = ViterbiDecoder(img, pip=5.0, lmw=1.5, beam=beam, device=cuda,
                         backend="auto" if kind == "collapsed" else "pallas")
    if kind == "collapsed":
        obj, fwd, ref = (dec._collapsed_fwd, vc.collapsed_viterbi_forward,
                         collapsed_viterbi_reference)
    else:
        obj, fwd, ref = (dec._pallas_fwd, cube_viterbi_forward,
                         cube_viterbi_reference)
    on_cluster = route != "global" and obj.plan.route == "cluster"
    assert (obj.plan.route == "cluster") == (phones != 9)
    assert obj.plan.registers == (kind == "collapsed")
    if kind == "cube":
        assert (obj.PS > obj.P) == (phones != 8)
    name = f"{kind}_viterbi_forward" + ("" if on_cluster else ".global")
    before = dict(kernels.launches)
    packed, end = fwd(obj, lp, lens, route=route)
    torch.cuda.synchronize()
    counted = {k: v - before.get(k, 0) for k, v in kernels.launches.items()
               if v != before.get(k, 0)}
    assert counted == ({name: 1, f"{name}.registers": 1} if route is None
                       and obj.plan.registers else {name: 1})
    want_packed, want_end = ref(obj, lp, lens)
    np.testing.assert_array_equal(packed.cpu().numpy(),
                                  want_packed.cpu().numpy())
    assert np.array_equal(end.cpu().numpy(), want_end.cpu().numpy(),
                          equal_nan=True)
    if beam is None:
        assert np.isnan(want_end.cpu().numpy()).any()
    if kind == "collapsed":
        assert (want_packed.cpu().numpy() == 2 ** 31 - 1).any()


@pytest.mark.parametrize("kind,route", [
    ("collapsed", None), ("collapsed", "shared"), ("cube", None)])
def test_viterbi_kernels_entry_times_at_the_pack_limit(cuda, kind, route):
    """T = pack - 2, the most frames a pack factor holds: entry times up to
    T - 2 (and -1, an entry at frame 0) kept on the cluster routes (the
    collapsed kernel's register route and its shared-memory route; the
    cube kernel's), bit-equal to the plain version within lengths."""
    from nnacousticmodeling_tpu_torch.decoder import viterbi_collapsed as vc
    from nnacousticmodeling_tpu_torch.decoder import viterbi_cube as vcube
    img = _viterbi_image(4)
    dec = ViterbiDecoder(img, pip=5.0, lmw=1.5, device=cuda,
                         backend="auto" if kind == "collapsed" else "pallas")
    if kind == "collapsed":
        obj, fwd, ref = (dec._collapsed_fwd, vc.collapsed_viterbi_forward,
                         collapsed_viterbi_reference)
        pack = obj.pack
    else:
        obj, fwd, ref = (dec._pallas_fwd, cube_viterbi_forward,
                         cube_viterbi_reference)
        pack = vcube.TIME_PACK
    assert obj.plan.registers == (kind == "collapsed")
    t = pack - 2
    lens = torch.tensor([t, t - 1, 5], dtype=torch.int32, device=cuda)
    rng = np.random.default_rng(pack)
    lp = torch.from_numpy(np.log(rng.dirichlet(
        np.ones(obj.S), size=(3, t))).astype(np.float32)).to(cuda)
    packed, end = fwd(obj, lp, lens, route=route)
    want_packed, want_end = ref(obj, lp, lens)
    for i, n in enumerate(lens.tolist()):
        assert torch.equal(packed[i, :n], want_packed[i, :n])
        assert torch.equal(end[i, :n], want_end[i, :n])
    # the keys' entry times (tt + 1) reach past half the pack factor
    assert int((want_packed[0, :t] % pack).max()) > pack // 2


@pytest.mark.parametrize("beam", [None, 2.0])
@pytest.mark.parametrize("num_phones,cluster", [
    (8, 1), (16, 2), (24, 8), (32, 8), (40, 16), (48, 16)])
def test_collapsed_register_kernel_of_each_step_count(cuda, num_phones,
                                                      cluster, beam):
    """Each register-route kernel (PS / 4 = 2, 4, ..., 12 row steps) on a
    cluster whose slice is one chunk a warp, and the shared-memory route
    on the same cluster: bit-equal to the plain version within lengths
    (0, 1 and T among them). The plans of 16 and 24 phones take fewer,
    wider blocks at these pdf counts, so the cluster is given here."""
    from nnacousticmodeling_tpu_torch.decoder import viterbi_collapsed as vc
    img = _viterbi_image(num_phones)
    ck = ViterbiDecoder(img, pip=5.0, lmw=1.5, beam=beam,
                        device=cuda)._collapsed_fwd
    w = ck.L // cluster
    assert ck.PS == num_phones and w % vc.LANE_CHUNK == 0
    assert vc.registers_fit(ck.PS, w)
    rng = np.random.default_rng(num_phones)
    t = 17
    lens = torch.tensor([t, 0, 1, 9, t - 1], dtype=torch.int32, device=cuda)
    lp = torch.from_numpy(np.log(rng.dirichlet(
        np.ones(ck.S), size=(5, t))).astype(np.float32)).to(cuda)
    want_packed, want_end = collapsed_viterbi_reference(ck, lp, lens)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for registers in (True, False):
        plan = vc.ViterbiPlan(
            "cluster", cluster, w, 32 * min(w // vc.LANE_CHUNK,
                                            vc.MAX_WARPS),
            vc.cluster_smem_bytes(ck.PS, ck.L, ck.S, cluster, registers),
            registers)
        packed, end = vc._collapsed_launch(ck, lp, lens, plan, vc._lib(),
                                           stream)
        for i, n in enumerate(lens.tolist()):
            assert torch.equal(packed[i, :n], want_packed[i, :n])
            assert torch.equal(end[i, :n], want_end[i, :n])


# ---- the backtrace kernel -------------------------------------------------
def _to_bac(img):
    """The same model with triphones enumerated center-major (idx =
    b*P^2 + a*P + c), the graph builder's 'bac' order."""
    import dataclasses
    from nnacousticmodeling_tpu_torch.decoder.image import (
        _csr_from_biphone_out)
    P = img.num_phones
    b, a, c = np.meshgrid(np.arange(P), np.arange(P), np.arange(P),
                          indexing="ij")
    old = (a * P * P + b * P + c).reshape(-1)
    bi_out = img.biphone_out[old]
    offsets, values = _csr_from_biphone_out(bi_out, img.num_biphones)
    return dataclasses.replace(
        img, biphone_in=img.biphone_in[old], biphone_out=bi_out,
        state_idxs=img.state_idxs[old], tp_selfloop=img.tp_selfloop[old],
        tp_transition=img.tp_transition[old], out_offsets=offsets,
        out_values=values,
        phone_names=[img.phone_names[i] for i in old]).validate()


def _backtrace_tables(dec, backend):
    return {"collapsed": dec._bt_collapsed, "pallas": dec._bt_cube,
            "xla": dec._bt_scan}[backend]


def _check_backtrace_kernel(tables, packed, end, lens, pack, routes=None):
    """The kernel (one launch, no synchronising call) against the plain
    walk on the same card tensors: segs bit-equal padding included,
    counts equal, on the route the rule picks and on each of ``routes``
    (default: every route the tables can take). Returns the counts."""
    from nnacousticmodeling_tpu_torch.decoder import viterbi_backtrace as vbt
    want = vbt.viterbi_backtrace_reference(tables, packed, end, lens, pack)
    torch.cuda.synchronize()
    if routes is None:
        routes = vbt.backtrace_routes(tables)
    calls = [lambda: vbt.backtrace(tables, packed, end, lens, pack)] + [
        (lambda r=r: vbt.viterbi_backtrace(tables, packed, end, lens, pack,
                                           route=r)) for r in routes]
    for call in calls:
        before = kernels.launches["viterbi_backtrace"]
        try:
            torch.cuda.set_sync_debug_mode("error")
            got = call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert kernels.launches["viterbi_backtrace"] == before + 1
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.int64
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return got[1]


@pytest.mark.parametrize("num_phones,pack_t", [(8, 23), (8, 2100), (8, 4100),
                                               (48, 23)])
@pytest.mark.parametrize("backend", ["collapsed", "pallas", "xla"])
@pytest.mark.parametrize("order", ["abc", "bac"])
def test_backtrace_kernel_bit_equal_on_adversarial_rows(cuda, order, backend,
                                                        num_phones, pack_t):
    """Rows no forward makes: random predecessors, entry times at or after
    their own frame (the guard), ties in every last end row and NaN in
    one, lengths 0, 1, 2 and T; both cube orders; T=2100 and T=4100 grow
    the pack factor to 4096 and 8192; at 48 phones the lane-map tables
    (110,592 triphones: 216 KB as int16) and bi2lane at full size. Every
    route (the lane map's two)."""
    img = _viterbi_image(num_phones)
    if order == "bac":
        img = _to_bac(img)
    dec = ViterbiDecoder(img, pip=5.0, lmw=1.5, backend=backend, device=cuda)
    assert dec.backend == backend and dec._cube_order == order
    tables = _backtrace_tables(dec, backend)
    rng = np.random.default_rng(len(order) * 10 + len(backend) + pack_t
                                + num_phones)
    t = pack_t
    if backend == "collapsed":
        pack, lanes, top = (dec._collapsed_for_t(t).pack,
                            dec._collapsed_for_t(t).L, img.num_phones)
    else:
        pack = dec._time_pack_for(t)
        lanes, top = img.num_biphones, img.num_triphones
    assert pack == {23: 2048, 2100: 4096, 4100: 8192}[t]
    lens = np.array([t, 0, 1, 2] + list(rng.integers(0, t + 1, 5)),
                    np.int32)
    u = len(lens)
    frame = np.arange(t)[None, :, None]
    t_entry = rng.integers(-1, frame + 1, size=(u, t, lanes))
    late = rng.random((u, t, lanes)) < 0.35
    t_entry = np.where(late, frame + rng.integers(0, 3, (u, t, lanes)),
                       t_entry)
    packed = (rng.integers(0, top, (u, t, lanes)) * pack
              + np.minimum(t_entry, pack - 2) + 1).astype(np.int32)
    end = rng.choice(np.asarray([-3.0, -1.5, -1.5], np.float32),
                     size=(u, t, img.num_phones))
    end[4, max(lens[4] - 1, 0), rng.integers(0, img.num_phones)] = np.nan
    counts = _check_backtrace_kernel(
        tables, torch.from_numpy(packed).to(cuda),
        torch.from_numpy(end).to(cuda), torch.from_numpy(lens).to(cuda),
        pack)
    assert counts[1] == 0 and (counts[[0, 2, 3]] > 0).all()


@pytest.mark.parametrize("pack", [2048, 4096, 8192])
@pytest.mark.parametrize("mode,route", [
    ("abc", "shared"), ("bac", "shared"), ("lanes", "shared"),
    ("lanes", "global")])
def test_backtrace_kernel_ends_walks_at_out_of_range_indices(cuda, mode,
                                                             route, pack):
    """Walks planted to end on what no forward makes (negative entries,
    q < 0, q past its table, a tri past int32, a lane out of range) and
    in range (the frame guard, frame 0): the kernel gives the plan's rows
    and the numpy transcription's, bit for bit (the plain walk raises
    or wraps on such indices)."""
    from test_torch_backtrace_model import (
        ENDINGS, MODES, _tables, kernel_model, planted_walks)
    from nnacousticmodeling_tpu_torch.decoder import viterbi_backtrace as vbt
    rng = np.random.default_rng(pack + len(mode))
    P, L, T = (48, 64, 30) if mode == "abc" else (4, 10, 40)
    tables = _tables(MODES[mode], P, L, rng, bad_lane=True)
    lens = [T, 0, 1, 2] + [int(n) for n in rng.integers(3, T + 1, 12)]
    ends = [ENDINGS[u % len(ENDINGS)] for u in range(len(lens))]
    packed, end, segs, counts = planted_walks(tables, pack, T, L, lens,
                                              ends, rng)
    lens = np.asarray(lens, np.int32)
    model = kernel_model(tables, packed, end, lens, pack, route)
    np.testing.assert_array_equal(model[0], segs)
    on = vbt.backtrace_tables(
        tables.mode, P, tables.end_map.to(cuda), tables.step_map.to(cuda))
    got = vbt.viterbi_backtrace(
        on, torch.from_numpy(packed).to(cuda), torch.from_numpy(end).to(cuda),
        torch.from_numpy(lens).to(cuda), pack, route=route)
    np.testing.assert_array_equal(got[0].cpu().numpy(), segs)
    np.testing.assert_array_equal(got[1].cpu().numpy(), counts)


def test_backtrace_kernel_refuses_bad_packs_and_routes(cuda):
    """A pack factor that is not a power of two raises before a launch,
    as do the shared route for a table that does not fit (a 49-phone
    lane map), the global route of a collapsed walk and an unknown
    route."""
    from nnacousticmodeling_tpu_torch.decoder import viterbi_backtrace as vbt
    tables = vbt.backtrace_tables(
        vbt.LANES, 49, torch.arange(49, device=cuda),
        torch.arange(49 ** 3, device=cuda) % 2401)
    assert vbt.backtrace_route(tables) == "global"
    packed = torch.zeros((2, 4, 2401), dtype=torch.int32, device=cuda)
    end = torch.zeros((2, 4, 49), device=cuda)
    lens = torch.full((2,), 4, dtype=torch.int32, device=cuda)
    before = kernels.launches["viterbi_backtrace"]
    for pack in (3000, 0, 6144):
        with pytest.raises(ValueError, match="power of two"):
            vbt.viterbi_backtrace(tables, packed, end, lens, pack)
    with pytest.raises(ValueError, match="shared route"):
        vbt.viterbi_backtrace(tables, packed, end, lens, 2048,
                              route="shared")
    with pytest.raises(ValueError, match="unknown route"):
        vbt.viterbi_backtrace(tables, packed, end, lens, 2048, route="smem")
    bi = vbt.backtrace_tables(
        vbt.COLLAPSED_ABC, 49, torch.arange(49, device=cuda),
        torch.arange(49 ** 2, device=cuda) % 2401)
    with pytest.raises(ValueError, match="no 'global' route"):
        vbt.viterbi_backtrace(bi, packed, end, lens, 2048, route="global")
    assert kernels.launches["viterbi_backtrace"] == before
    segs, counts = vbt.viterbi_backtrace(tables, packed, end, lens, 2048)
    assert kernels.launches["viterbi_backtrace"] == before + 1
    # entry 0: t_new = -1 at the first hop, tri 0
    assert counts.tolist() == [1, 1]
    assert segs[:, 0].tolist() == [[0, 4, 0], [0, 4, 0]]


@pytest.mark.parametrize("backend,num_phones,route", [
    ("collapsed", 4, None), ("collapsed", 4, "global"),
    ("collapsed", 48, None), ("collapsed", 48, "global"),
    ("pallas", 8, None), ("pallas", 8, "global"), ("pallas", 9, None),
    ("pallas", 8, "twin"), ("xla", 4, None), ("xla", 48, None)])
def test_backtrace_kernel_bit_equal_on_forward_rows(cuda, backend,
                                                    num_phones, route):
    """Rows of the collapsed and cube kernels (the plan's route and the
    device-memory route) and of the scan twin (``route="twin"`` on a cube
    decoder, as ``decode_fn``): the kernel equals the plain walk, the
    decoder's backtrace launches it once a call, and the segments are the
    CPU decoder's."""
    from nnacousticmodeling_tpu_torch.decoder import viterbi_collapsed as vc
    from nnacousticmodeling_tpu_torch.decoder import viterbi_cube as vcube
    img = _viterbi_image(num_phones)
    dec = ViterbiDecoder(img, pip=5.0, lmw=1.5, beam=2.0, backend=backend,
                         device=cuda)
    rng = np.random.default_rng(num_phones + 3)
    t = 37
    lens = np.array([t, 0, 1, 2, 20, 36, 9], np.int32)
    lp = torch.from_numpy(np.log(rng.dirichlet(
        np.ones(img.num_states), size=(len(lens), t))).astype(
            np.float32)).to(cuda)
    lens_t = torch.from_numpy(lens).to(cuda)
    if route == "twin" or backend == "xla":
        packed, end = dec._forward_scan(lp)
        tables, pack = dec._bt_scan, dec._time_pack_for(t)
        walk = dec._device_backtrace
    elif backend == "collapsed":
        packed, end = vc.collapsed_viterbi_forward(dec._collapsed_fwd, lp,
                                                   lens_t, route=route)
        tables, pack = dec._bt_collapsed, dec._collapsed_fwd.pack
        walk = dec._collapsed_backtrace
    else:
        packed, end = vcube.cube_viterbi_forward(dec._pallas_fwd, lp, lens_t,
                                                 route=route)
        tables, pack = dec._bt_cube, dec._time_pack_for(t)
        walk = dec._pallas_backtrace
    counts = _check_backtrace_kernel(tables, packed, end, lens_t, pack)
    assert counts[1] == 0 and (counts[[0, 4, 5, 6]] > 0).all()
    before = kernels.launches["viterbi_backtrace"]
    segs, counts2 = walk(packed, end, lens_t)
    assert kernels.launches["viterbi_backtrace"] == before + 1
    assert torch.equal(counts2, counts)
    cpu = ViterbiDecoder(img, pip=5.0, lmw=1.5, beam=2.0, backend=backend,
                         device="cpu")
    want = cpu.decode_batch(lp.cpu().numpy(), lens)
    got = dec._to_results(segs.cpu().numpy(), counts2.cpu().numpy())
    assert [r.segments for r in got] == [r.segments for r in want]


@pytest.mark.parametrize("fn", ["decode_arrays_fn", "decode_fn"])
@pytest.mark.parametrize("backend,num_phones", [
    ("collapsed", 4), ("collapsed", 48), ("pallas", 8), ("xla", 4)])
def test_device_decode_callables(cuda, backend, num_phones, fn):
    """``decode_arrays_fn`` / ``decode_fn`` on device lengths make no
    synchronising call (sync debug mode "error") and give the CPU
    decoder's ``decode_batch`` segments; a CPU ``lp`` raises."""
    img = _viterbi_image(num_phones)
    dec = ViterbiDecoder(img, pip=5.0, lmw=1.5, beam=2.0, backend=backend,
                         device=cuda)
    cpu = ViterbiDecoder(img, pip=5.0, lmw=1.5, beam=2.0, backend=backend,
                         device="cpu")
    rng = np.random.default_rng(num_phones)
    lens = np.array([37, 0, 1, 2, 20, 36], np.int32)
    lp = np.log(rng.dirichlet(np.ones(img.num_states), size=(len(lens), 37))
                ).astype(np.float32)
    lp_t = torch.from_numpy(lp).to(cuda)
    lens_t = torch.from_numpy(lens).to(cuda)
    call = getattr(dec, fn)()
    call(lp_t, lens_t)                        # builds the kernels first
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        segs, counts = call(lp_t, lens_t)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = dec._to_results(segs.cpu().numpy(), counts.cpu().numpy())
    want = cpu.decode_batch(lp, lens)
    assert [r.segments for r in got] == [r.segments for r in want]
    assert int(counts[1]) == 0
    with pytest.raises(ValueError):
        call(torch.from_numpy(lp), lens_t)


def _scan_image(name):
    """The scan kernel's test images: untied cubes ('abc'; 'ci' with
    context-independent pdfs; 'bac'), a partial image, one with empty
    fan-in rows, and the 48-phone 1909-pdf untied cube of chip_smoke.py
    phase 23."""
    import dataclasses
    if name == "untied":
        return make_synthetic_image(num_phones=4, seed=0)
    if name == "ci":
        return make_synthetic_image(num_phones=4, seed=1, tied=False)
    if name == "untied_bac":
        return _to_bac(make_synthetic_image(num_phones=3, seed=3))
    if name == "partial":
        return make_synthetic_image(num_phones=3, seed=2,
                                    full_context=False)
    if name == "empty_rows":
        img = make_synthetic_image(num_phones=4, seed=6, full_context=False)
        keep = ~np.isin(img.biphone_out, [1, 6, 11])
        bi_out = img.biphone_out[keep]
        offsets = np.zeros(img.num_biphones + 1, np.int32)
        np.cumsum(np.bincount(bi_out, minlength=img.num_biphones),
                  out=offsets[1:])
        return dataclasses.replace(
            img, num_triphones=int(keep.sum()),
            biphone_in=img.biphone_in[keep], biphone_out=bi_out,
            state_idxs=img.state_idxs[keep],
            tp_selfloop=img.tp_selfloop[keep],
            tp_transition=img.tp_transition[keep], out_offsets=offsets,
            out_values=np.argsort(bi_out, kind="stable").astype(np.int32),
            phone_names=[img.phone_names[i]
                         for i in np.flatnonzero(keep)]).validate()
    if name == "partial48":
        return make_synthetic_image(num_phones=48, num_states=1909,
                                    full_context=False)
    assert name == "untied48"
    return make_synthetic_image(num_phones=48, num_states=1909)


def _scan_lp(img, u, t, seed):
    """Dirichlet log-posteriors with an all-NaN frame, a half-NaN frame
    and a frame that is -inf for two thirds of the pdfs."""
    rng = np.random.default_rng(seed)
    s = img.num_states
    lp = np.log(rng.dirichlet(np.ones(s), size=(u, t))).astype(np.float32)
    lp[0, t // 3] = np.nan
    lp[-1, t // 2, : s // 2] = np.nan
    lp[u // 2, (2 * t) // 3, : (2 * s) // 3] = -np.inf
    return lp


@pytest.mark.parametrize("name,beam,t", [
    (n, b, t) for n in ("untied", "ci", "untied_bac", "partial",
                        "empty_rows")
    for b in (None, 2.0) for t in (14, 2100)] + [
    ("untied48", None, 14), ("untied48", 8.0, 14)])
def test_scan_kernel_bit_equal_to_plain_twins(cuda, name, beam, t):
    """``viterbi_scan_forward``: every packed entry and end score (NaN
    included) equal to the plain twins (general, and cube on a cube) on
    the CPU and on the card, on NaN and -inf frames; T = 2100 packs at
    4096. ``_forward_scan`` launches it once a call on the card."""
    from nnacousticmodeling_tpu_torch.decoder import viterbi_scan as vscan
    img = _scan_image(name)
    u = 3 if t == 14 else 2
    lp = _scan_lp(img, u, t, seed=t + len(name))
    kw = dict(pip=5.0, lmw=1.5, beam=beam, backend="xla")
    dec = ViterbiDecoder(img, device=cuda, **kw)
    cpu = ViterbiDecoder(img, device="cpu", **kw)
    lp_t = torch.from_numpy(lp).to(cuda)
    pack = dec._time_pack_for(t)
    assert pack == (4096 if t == 2100 else 2048)
    before = kernels.launches["viterbi_scan_forward"]
    got = dec._forward_scan(lp_t)
    assert kernels.launches["viterbi_scan_forward"] == before + 1
    again = vscan.viterbi_scan_forward(dec._scan, lp_t, pack)
    torch.cuda.synchronize()
    wants = [cpu._forward_scan_general(torch.from_numpy(lp)),
             dec._forward_scan_general(lp_t)]
    if dec._cube_order is not None:
        wants += [cpu._forward_scan_cube(torch.from_numpy(lp),
                                         cpu._cube_order),
                  dec._forward_scan_cube(lp_t, dec._cube_order)]
    for want in wants + [again]:
        np.testing.assert_array_equal(got[0].cpu().numpy(),
                                      want[0].cpu().numpy())
        assert np.array_equal(got[1].cpu().numpy(), want[1].cpu().numpy(),
                              equal_nan=True)
    assert np.isnan(got[1].cpu().numpy()).any() == (beam is None)


@pytest.mark.parametrize("beam", [None, 2.0])
@pytest.mark.parametrize("name", ["untied", "untied_bac", "partial",
                                  "empty_rows", "untied48", "partial48"])
def test_scan_kernel_routes_bit_equal(cuda, name, beam):
    """The scan kernel's two routes (the plan's cluster route, the
    device-memory route forced) on NaN and -inf frames, with more
    utterances than the card holds clusters at once: each bit-equal to
    the general twin and to the other route, counted apart; the 48-phone
    images take 16-block clusters, the small ones 1."""
    from nnacousticmodeling_tpu_torch.decoder import viterbi_scan as vscan
    img = _scan_image(name)
    dec = ViterbiDecoder(img, pip=5.0, lmw=1.5, beam=beam, backend="xla",
                         device=cuda)
    tables = dec._scan
    assert tables.plan.route == "cluster"
    assert tables.plan.cluster == (16 if name.endswith("48") else 1)
    clusters = vscan.scan_cluster_capacity(tables)
    assert clusters >= 1
    t = 14
    lp = torch.from_numpy(_scan_lp(img, clusters + 3, t, seed=len(name))
                          ).to(cuda)
    pack = dec._time_pack_for(t)
    before = dict(kernels.launches)
    got = {route: vscan.viterbi_scan_forward(tables, lp, pack, route=route)
           for route in (None, "global")}
    torch.cuda.synchronize()
    counted = {k: v - before.get(k, 0) for k, v in kernels.launches.items()
               if v != before.get(k, 0)}
    assert counted == {"viterbi_scan_forward": 1,
                       "viterbi_scan_forward.global": 1}
    want = dec._forward_scan_general(lp)
    for packed, end in list(got.values()) + [got[None]]:
        np.testing.assert_array_equal(packed.cpu().numpy(),
                                      want[0].cpu().numpy())
        assert np.array_equal(end.cpu().numpy(), want[1].cpu().numpy(),
                              equal_nan=True)
    assert torch.equal(got[None][0], got["global"][0])
    again = vscan.viterbi_scan_forward(tables, lp, pack)
    assert torch.equal(again[0], got[None][0])


@pytest.mark.parametrize("name", ["untied", "partial", "empty_rows"])
def test_decode_fn_launches_the_scan_kernel_and_the_backtrace(cuda, name):
    """One ``decode_fn`` call: the two kernels once each, no plain twin,
    and the CPU decoder's segments (``backend="xla"``)."""
    img = _scan_image(name)
    kw = dict(pip=5.0, lmw=1.5, beam=2.0, backend="xla")
    dec = ViterbiDecoder(img, device=cuda, **kw)
    cpu = ViterbiDecoder(img, device="cpu", **kw)
    rng = np.random.default_rng(len(name))
    lens = np.array([37, 0, 1, 2, 20, 36], np.int32)
    lp = np.log(rng.dirichlet(np.ones(img.num_states), size=(len(lens), 37))
                ).astype(np.float32)
    fn = dec.decode_fn()
    lens_t = torch.from_numpy(lens).to(cuda)

    def refuse(*a, **k):
        raise AssertionError("a plain twin ran on the card")

    dec._forward_scan_plain = refuse
    kernels.reset_launches()
    segs, counts = fn(torch.from_numpy(lp).to(cuda), lens_t)
    assert dict(kernels.launches) == {"viterbi_scan_forward": 1,
                                      "viterbi_backtrace": 1}
    got = dec._to_results(segs.cpu().numpy(), counts.cpu().numpy())
    want = cpu.decode_batch(lp, lens)
    assert [r.segments for r in got] == [r.segments for r in want]


def test_scan_kernel_refuses_malformed_tables(cuda):
    """A malformed table, a CPU table, a wrong dtype or a pack that does
    not hold T raises, counts no launch and never runs a plain twin; a
    (0, T) or (U, 0) batch launches nothing."""
    import dataclasses
    from nnacousticmodeling_tpu_torch.decoder import viterbi_scan as vscan
    img = _scan_image("partial")
    dec = ViterbiDecoder(img, device=cuda)
    tables = dec._scan
    lp = torch.zeros((2, 5, img.num_states), device=cuda)
    before = dict(kernels.launches)
    bad = {
        "exactly once": dataclasses.replace(tables, zero_slot=-1),
        "table idx": dataclasses.replace(tables, idx=tables.idx[:, :-1]),
        "table count": dataclasses.replace(tables,
                                           count=tables.count[:-1]),
        "table records": dataclasses.replace(tables,
                                             records=tables.records[:-1]),
        "tables on cpu": vscan.scan_tables(
            img, tables.lm.cpu().numpy(), tables.p0.cpu().numpy(),
            tables.pip, None, "cpu"),
    }
    for match, tab in bad.items():
        with pytest.raises(ValueError, match=match):
            vscan.viterbi_scan_forward(tab, lp, 2048)
    with pytest.raises(ValueError, match="float32"):
        vscan.viterbi_scan_forward(tables, lp.double(), 2048)
    with pytest.raises(ValueError, match="CUDA"):
        vscan.viterbi_scan_forward(tables, lp.cpu(), 2048)
    with pytest.raises(ValueError, match="pack"):
        vscan.viterbi_scan_forward(tables, lp, 4)
    dec._scan = bad["exactly once"]
    dec._forward_scan_plain = None          # calling it would raise
    with pytest.raises(ValueError, match="exactly once"):
        dec.decode_fn()(lp, torch.full((2,), 5, dtype=torch.int32,
                                       device=cuda))
    for shape in ((0, 5), (2, 0)):
        packed, end = vscan.viterbi_scan_forward(
            tables, torch.zeros(shape + (img.num_states,), device=cuda),
            2048)
        assert packed.shape == shape + (img.num_biphones,)
        assert end.shape == shape + (img.num_phones,)
    assert dict(kernels.launches) == before


@pytest.mark.parametrize("kaldi_weights", [False, True])
@pytest.mark.parametrize("n", [400, 12000, 160 * 37 + 240, 399, 160 * 5 + 400,
                               160 * 4 + 400])
def test_fbank_kernel_matches_plain(cuda, n, kaldi_weights):
    """0, 1, 5, 6 (a partial last block of 4), 37 and 73 frames: both
    entries within 1e-3 of their plain versions, and bit-equal to each
    other (the kernel's framing gives frame_signal(x) * win's bits)."""
    x = (np.random.default_rng(n).standard_normal(n) * 0.1
         ).astype(np.float32)
    t = features.num_frames(n)
    before = kernels.launches["fbank"]
    got = features.fbank_cuda(x, kaldi_weights=kaldi_weights)
    torch.cuda.synchronize()
    assert kernels.launches["fbank"] == before + (t > 0)
    wave = torch.from_numpy(x).to(cuda)
    want = features.fbank(wave, kaldi_weights=kaldi_weights)
    assert got.shape == want.shape == (t, 40)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
    frames = features.frame_signal(wave)
    got_f = features.fbank_frames(frames, kaldi_weights=kaldi_weights)
    torch.cuda.synchronize()
    assert kernels.launches["fbank"] == before + 2 * (t > 0)
    torch.testing.assert_close(
        got_f, features.fbank_frames_reference(
            frames, kaldi_weights=kaldi_weights), rtol=0, atol=1e-3)
    assert torch.equal(got_f, got)
    m = features.mfcc(x, kaldi_weights=kaldi_weights)
    assert kernels.launches["fbank"] == before + 3 * (t > 0)
    assert m.device.type == "cuda" and m.shape == (t, 13)


def _wide_range_wave(n, seed):
    """A loud 1 kHz tone, white noise 60 dB below it, and a 0.25 s stretch
    of zeros: chip_smoke.py phase 24's wide-range case."""
    rng = np.random.default_rng(seed)
    x = 0.9 * np.sin(2 * np.pi * 1000.3 * np.arange(n) / 16000.0)
    x += 0.9e-3 * rng.standard_normal(n)
    x[n // 3:n // 3 + 4000] = 0.0
    return x.astype(np.float32)


def _fbank_twin64(frames, kaldi_weights):
    """float64 log-mel of windowed frames (T, 400): rfft power, mel, log."""
    power = np.abs(np.fft.rfft(frames.astype(np.float64), n=512)) ** 2
    mel = power @ features.mel_filterbank(
        kaldi_weights=kaldi_weights).astype(np.float64)
    return np.log(np.maximum(mel, features.EPS))


@pytest.mark.parametrize("kaldi_weights", [False, True])
def test_fbank_kernel_wide_range(cuda, kaldi_weights):
    """93 dB between a frame's loudest and quietest mel bands, where
    float32 transforms lose most. Kernel and plain version, each against
    a float64 twin of the float32 windowed frames both transform (the
    frames' own rounding is common to both, and larger than either
    transform's error): the kernel lies no farther from the twin than the
    plain version, plus 1e-4."""
    x = _wide_range_wave(48000, 24)
    wave = torch.from_numpy(x).to(cuda)
    frames = features.frame_signal(wave)
    twin = _fbank_twin64((frames * torch.from_numpy(
        features.povey_window()).to(cuda)).cpu().numpy(), kaldi_weights)
    got = features.fbank_cuda(wave, kaldi_weights=kaldi_weights)
    want = features.fbank(wave, kaldi_weights=kaldi_weights)
    assert torch.isfinite(got).all() and got.shape == want.shape
    err = float(np.abs(got.cpu().numpy() - twin).max())
    err_plain = float(np.abs(want.cpu().numpy() - twin).max())
    assert err <= err_plain + 1e-4, (err, err_plain)
    assert torch.equal(features.fbank_frames(
        frames, kaldi_weights=kaldi_weights), got)


def test_new_wrappers_raise_and_never_fall_back(cuda):
    img = make_synthetic_image(num_phones=3, seed=0,
                               pdf_tied_transitions=True)
    cv = ViterbiDecoder(img, backend="pallas", device=cuda)._pallas_fwd
    lens = torch.full((1,), 4, dtype=torch.int32)
    lp = torch.zeros((1, 4, img.num_states))
    with pytest.raises(ValueError, match="CUDA"):
        cube_viterbi_forward(cv, lp, lens)
    with pytest.raises(ValueError, match="float32"):
        cube_viterbi_forward(cv, lp.double().to(cuda), lens.to(cuda))
    with pytest.raises(ValueError, match="2047"):
        cube_viterbi_forward(cv, torch.zeros((1, 2047, img.num_states),
                                             device=cuda), lens.to(cuda))
    with pytest.raises(ValueError, match="CUDA"):
        features.fbank_frames(torch.zeros(3, 400))
    with pytest.raises(ValueError, match="float32"):
        features.fbank_frames(torch.zeros(3, 400, dtype=torch.float64,
                                          device=cuda))
    before = dict(kernels.launches)
    features.fbank_cuda(np.zeros(800, np.float32), device="cpu")
    assert dict(kernels.launches) == before


@pytest.mark.parametrize("geometry", ["collapsed", "cube"])
def test_failed_cluster_launch_raises(cuda, geometry):
    """A cluster launch the card refuses (a cluster of 32 blocks) raises,
    counts no launch and never falls back to the device-memory route or
    the plain version; so does a refused capacity query and an unknown
    route."""
    import dataclasses
    from nnacousticmodeling_tpu_torch.decoder import viterbi_collapsed as vc
    from nnacousticmodeling_tpu_torch.decoder import viterbi_cube as vcube
    img = _viterbi_image(8)
    if geometry == "collapsed":
        obj = ViterbiDecoder(img, device=cuda)._collapsed_fwd
        forward, capacity = (vc.collapsed_viterbi_forward,
                             vc.collapsed_cluster_capacity)
    else:
        obj = ViterbiDecoder(img, backend="pallas", device=cuda)._pallas_fwd
        forward, capacity = (cube_viterbi_forward,
                             vcube.cube_cluster_capacity)
    assert obj.plan.route == "cluster"
    lp = torch.zeros((2, 4, obj.S), device=cuda)
    lens = torch.full((2,), 4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="route"):
        forward(obj, lp, lens, route="cluster")
    obj.plan = dataclasses.replace(obj.plan, cluster=32)
    before = dict(kernels.launches)
    with pytest.raises(RuntimeError, match="CUDA error"):
        forward(obj, lp, lens)
    with pytest.raises(RuntimeError, match="CUDA error"):
        capacity(obj)
    assert dict(kernels.launches) == before


def _train_case(t, b, h, dtype, device):
    g = torch.Generator().manual_seed(t * 1000 + b * 10 + h)
    proj = (torch.randn(t, b, 4 * h, generator=g) * 0.5).to(dtype)
    wh = torch.randn(h, 4 * h, generator=g) * min(0.1, 2.0 / h ** 0.5)
    c0 = torch.randn(b, h, generator=g) * 0.1
    h0 = torch.randn(b, h, generator=g) * 0.1
    return [x.to(device) for x in (proj, wh, c0, h0)]


# (3, 4, 2048): W_h streamed from L2; (3, 300, 1024): three row chunks of
# 128, 128 and 44 rows; (1, 1, 40): one step, one row
TRAIN_SIZES = [(5, 4, 32), (13, 33, 40), (8, 3, 64), (3, 4, 2048),
               (3, 300, 1024), (1, 1, 40)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,h", TRAIN_SIZES)
def test_lstm_train_forward_kernel(cuda, t, b, h, dtype):
    args = _train_case(t, b, h, dtype, cuda)
    before = kernels.launches["lstm_train_forward"]
    hs, res, ct, ht = lstm_train_forward(*args)
    torch.cuda.synchronize()
    assert kernels.launches["lstm_train_forward"] == before + 1
    # lstm_scan's kernel code with the residual stores: the same bits
    (cs, hs_c), hs_s = lstm_scan(*args)
    assert torch.equal(hs, hs_s)
    assert torch.equal(ct, cs) and torch.equal(ht, hs_c)
    hs_r, res_r, ct_r, ht_r = lstm_train_forward_reference(*args)
    torch.testing.assert_close(hs.float(), hs_r.float(), rtol=0,
                               atol=BF16_ATOL)
    torch.testing.assert_close(ct, ct_r, rtol=0, atol=BF16_ATOL)
    torch.testing.assert_close(ht, ht_r, rtol=0, atol=BF16_ATOL)
    torch.testing.assert_close(res.float(), res_r.float(), rtol=RES_RTOL,
                               atol=BF16_ATOL)


@pytest.mark.parametrize("proj_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,h", [(5, 3, 32), (13, 33, 40), (5, 33, 40),
                                   (13, 3, 32), (1, 1, 40)])
def test_lstm_train_backward_kernel(cuda, t, b, h, proj_dtype):
    _check_lstm_backward(cuda, t, b, h, proj_dtype)


# W_h streamed (H=2048) and three row chunks (B=300), float32 dproj. At
# these sizes some bf16 dproj value near the max rounds to the other
# neighbouring bf16 (2**-8 of it, beyond BWD_RTOL) after float32 sums in
# another order; the arithmetic is the same for both dtypes, and the
# bf16 store is checked at the sizes above.
@pytest.mark.parametrize("t,b,h", [(3, 4, 2048), (3, 300, 1024)])
def test_lstm_train_backward_kernel_streamed_and_chunked(cuda, t, b, h):
    _check_lstm_backward(cuda, t, b, h, torch.float32)


def _check_lstm_backward(cuda, t, b, h, proj_dtype):
    args = _train_case(t, b, h, proj_dtype, cuda)
    _, res, _, _ = lstm_train_forward_reference(*args)
    g = torch.Generator().manual_seed(7)
    dhs = torch.randn(t, b, h, generator=g).to(cuda, proj_dtype)
    dct = torch.randn(b, h, generator=g).to(cuda)
    dht = torch.randn(b, h, generator=g).to(cuda)
    before = dict(kernels.launches)
    got = lstm_train_backward(res, args[1], dhs, dct, dht, proj_dtype)
    torch.cuda.synchronize()
    assert kernels.launches["lstm_train_backward"] == \
        before.get("lstm_train_backward", 0) + 1
    assert kernels.launches["lstm_train_dw"] == \
        before.get("lstm_train_dw", 0) + 1
    want = lstm_train_backward_reference(res, args[1], dhs, dct, dht,
                                         proj_dtype)
    for k, w, name in zip(got, want, ["dproj", "dwh", "dc0", "dh0"]):
        assert k.dtype == w.dtype and k.shape == w.shape, name
        scale = float(w.float().abs().max())
        torch.testing.assert_close(k.float(), w.float(), rtol=0,
                                   atol=BWD_RTOL * scale, msg=name)
    again = lstm_train_backward(res, args[1], dhs, dct, dht, proj_dtype)
    assert all(torch.equal(a, k) for a, k in zip(again, got))


def test_lstm_scan_train_autograd_on_card(cuda):
    args = [x.requires_grad_() for x in _train_case(6, 8, 32, torch.float32,
                                                    cuda)]
    (ct, ht), hs = lstm_scan_train(*args)
    (hs.square().sum() + ct.sum()).backward()
    got = [x.grad for x in args]
    cpu = [x.detach().cpu().requires_grad_() for x in args]
    (ct, ht), hs = lstm_scan_train(*cpu)
    (hs.square().sum() + ct.sum()).backward()
    for k, w in zip(got, cpu):
        scale = float(w.grad.abs().max())
        torch.testing.assert_close(k.cpu(), w.grad, rtol=0,
                                   atol=1e-2 * scale)


def test_lstm_scan_refuses_grad_on_card(cuda):
    proj, wh, c0, h0 = _train_case(4, 4, 32, torch.float32, cuda)
    wh.requires_grad_()
    with pytest.raises(RuntimeError, match="lstm_scan_train"):
        lstm_scan(proj, wh, c0, h0)
    with torch.no_grad():
        lstm_scan(proj, wh, c0, h0)


# ---- the gated recurrences (GRU, MGRU with and without the reset gate) ---

GATED = {"gru": (3, "tanh"), "mgru_r": (3, "relu"), "mgru": (2, "relu")}


def _gated_case(kind, t, b, h, dtype, device):
    g = torch.Generator().manual_seed(t * 1000 + b * 10 + h)
    gp = GATED[kind][0]
    proj = (torch.randn(t, b, gp * h, generator=g) * 0.5).to(dtype)
    # the small sizes' scale, shrunk like 1 / sqrt(H) beyond H=100
    scale = min(0.2, 2.0 / h ** 0.5)
    w1 = torch.randn(h, 2 * h, generator=g) * scale
    w2 = None if kind == "mgru" else torch.randn(h, h, generator=g) * scale
    h0 = torch.randn(b, h, generator=g) * 0.1
    return [None if x is None else x.to(device) for x in (proj, w1, w2, h0)]


def _close_rel(got, want, rtol, msg=None, ulp=0.0):
    scale = max(float(want.float().abs().max()), 1.0)
    torch.testing.assert_close(got.float(), want.float(), rtol=ulp,
                               atol=rtol * scale, msg=msg)


# The serving shape (one launch, the slice resident) takes chip_smoke.py
# phase 12's inputs, at BF16_ATOL of max(1, max|plain|) with one bf16 ulp
# allowed for bf16 hs, as the wide cases allow it. _gated_case's weights
# (2 / sqrt(H)) make the 512-step recurrence ill-conditioned: there the
# float32 plain version and the kernel each lie ~4.2e-3 (gru) and, with
# the unbounded relu candidate and no reset gate (mgru), the whole of
# max|hs| from a float64 twin (bench_gated_wide_errors.py on an H100).
SERVING = (512, 128, 1024)


def _serving_case(kind, dtype, device):
    """chip_smoke.py phase 12's inputs at the serving shape: proj N(0, 1),
    w1 and w2 N(0, 1) / sqrt(H), h0 = 0."""
    t, b, h = SERVING
    g = torch.Generator().manual_seed(20 + GATED[kind][0])
    w1 = torch.randn(h, 2 * h, generator=g) / h ** 0.5
    w2 = None if kind == "mgru" else torch.randn(h, h, generator=g) / h ** 0.5
    proj = torch.randn(t, b, GATED[kind][0] * h, generator=g).to(dtype)
    return [None if x is None else x.to(device)
            for x in (proj, w1, w2, torch.zeros(b, h))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,h", [(5, 4, 32), (13, 33, 40), (8, 3, 64),
                                   SERVING])
@pytest.mark.parametrize("kind", sorted(GATED))
def test_gated_scan_kernel_matches_plain(cuda, kind, t, b, h, dtype):
    serving = (t, b, h) == SERVING
    args = (_serving_case(kind, dtype, cuda) if serving
            else _gated_case(kind, t, b, h, dtype, cuda))
    ulp = RES_RTOL if serving and dtype == torch.bfloat16 else 0.0
    act = GATED[kind][1]
    before = kernels.launches["gated_scan"]
    hk, hsk = gated_scan(*args, kind=kind, activation=act)
    torch.cuda.synchronize()
    assert kernels.launches["gated_scan"] == before + 1
    hr, hsr = gated_scan_reference(*args, kind=kind, activation=act)
    assert hsk.dtype == dtype and hsk.shape == (t, b, h)
    _close_rel(hsk, hsr, BF16_ATOL, ulp=ulp)
    _close_rel(hk, hr, BF16_ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,h", [(5, 4, 32), (13, 33, 40)])
@pytest.mark.parametrize("kind", sorted(GATED))
def test_gated_train_forward_kernel(cuda, kind, t, b, h, dtype):
    _check_gated_forward(cuda, kind, t, b, h, dtype)


# (3, 128, 1024): the training width, one launch, the weight slice
# resident in shared memory; (3, 4, 2048): streamed from L2; (3, 300,
# 1024): three row chunks of 128, 128 and 44 rows; (3, 4, 4240): 32-row
# blocks (H/16 streamed 64-row blocks are not co-resident)
GATED_WIDE = [(3, 128, 1024), (3, 4, 2048), (3, 300, 1024), (3, 4, 4240)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,h", GATED_WIDE)
@pytest.mark.parametrize("kind", sorted(GATED))
def test_gated_train_forward_kernel_wide(cuda, kind, t, b, h, dtype):
    _check_gated_forward(cuda, kind, t, b, h, dtype,
                         ulp=RES_RTOL if dtype == torch.bfloat16 else 0.0)


def _check_gated_forward(cuda, kind, t, b, h, dtype, ulp=0.0):
    args = _gated_case(kind, t, b, h, dtype, cuda)
    k = dict(kind=kind, activation=GATED[kind][1])
    before = kernels.launches["gated_train_forward"]
    out = gated_train_forward(*args, **k)
    hs, res, ht = out
    torch.cuda.synchronize()
    assert kernels.launches["gated_train_forward"] == before + 1
    again = gated_train_forward(*args, **k)
    assert all(torch.equal(a, o) for a, o in zip(again, out))
    # the scan runs the same kernel body: the same bits
    ht_s, hs_s = gated_scan(*args, **k)
    assert torch.equal(hs, hs_s) and torch.equal(ht, ht_s)
    hs_r, res_r, ht_r = gated_train_forward_reference(*args, **k)
    _close_rel(hs, hs_r, BF16_ATOL, ulp=ulp)
    _close_rel(ht, ht_r, BF16_ATOL)
    scale = max(float(res_r.float().abs().max()), 1.0)
    torch.testing.assert_close(res.float(), res_r.float(), rtol=RES_RTOL,
                               atol=BF16_ATOL * scale)


@pytest.mark.parametrize("proj_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,h", [(5, 3, 32), (13, 33, 40)])
@pytest.mark.parametrize("kind", sorted(GATED))
def test_gated_train_backward_kernel(cuda, kind, t, b, h, proj_dtype):
    _check_gated_backward(cuda, kind, t, b, h, proj_dtype)


# The forward's wide sizes (GATED_WIDE: resident, streamed, three row
# chunks, 32-row blocks), float32 dproj. Beside the plain version, dh0 and
# dW are held to the plain products of the kernel's own bf16 pair and dc
# (read off its float32 dproj), which isolate the kernel's sums from the
# bf16 roundings that sums in another order may flip.
@pytest.mark.parametrize("t,b,h", GATED_WIDE)
@pytest.mark.parametrize("kind", sorted(GATED))
def test_gated_train_backward_kernel_wide(cuda, kind, t, b, h):
    _check_gated_backward(cuda, kind, t, b, h, torch.float32, wide=True)


def _own_pair_dc(kind, dproj, h):
    """The bf16 pair and dc of a float32 dproj, in w1's column order."""
    d = dproj.to(torch.bfloat16)
    if kind == "gru":            # dproj [r, z, c], pair [r | z]
        return d[..., :2 * h], d[..., 2 * h:]
    if kind == "mgru_r":         # dproj [z, c, r], pair [z | r]
        return torch.cat([d[..., :h], d[..., 2 * h:]], -1), d[..., h:2 * h]
    return d, None               # dproj [z, c] = pair [z | c]


def _dh0_of_pair(res, w1, w2, dhs, dht, pair, dc):
    """dh0 of the plain reverse loop whose products take the given bf16
    pair and dc (the kernel's own) in place of its own roundings."""
    h = w1.shape[0]
    w1f, w2f = _bf16(w1), None if w2 is None else _bf16(w2)
    dh = dht.float()
    for t in range(res.shape[0] - 1, -1, -1):
        r, z, _, _ = res[t].float().split(h, dim=1)
        dh_new = (dhs[t].float() + dh) * (1.0 - z)
        if w2 is not None:
            dh_new = dh_new + (dc[t].float() @ w2f.T) * r
        dh = dh_new + pair[t].float() @ w1f.T
    return dh


def _check_gated_backward(cuda, kind, t, b, h, proj_dtype, wide=False):
    args = _gated_case(kind, t, b, h, proj_dtype, cuda)
    act = GATED[kind][1]
    k = dict(kind=kind, activation=act)
    _, res, _ = gated_train_forward_reference(*args, **k)
    g = torch.Generator().manual_seed(7)
    dhs = torch.randn(t, b, h, generator=g).to(cuda, proj_dtype)
    dht = torch.randn(b, h, generator=g).to(cuda)
    bargs = (res, args[1], args[2], dhs, dht, proj_dtype)
    before = dict(kernels.launches)
    got = gated_train_backward(*bargs, **k)
    torch.cuda.synchronize()
    assert kernels.launches["gated_train_backward"] == \
        before.get("gated_train_backward", 0) + 1
    assert kernels.launches["gated_train_dw"] == \
        before.get("gated_train_dw", 0) + 1
    want = gated_train_backward_reference(*bargs, **k)
    names = ["dproj", "dw1", "dw2", "dh0"]
    for kg, w, name in zip(got, want, names):
        if w is None:
            assert kg is None and kind == "mgru", name
            continue
        assert kg.dtype == w.dtype and kg.shape == w.shape, name
        if name == "dproj" and proj_dtype == torch.bfloat16:
            # a bf16 dproj value near the max can round to the other
            # neighbouring bf16 (2**-8 of it, beyond BWD_RTOL) after
            # float32 sums in another order: the bf16 store is held to
            # plain's with one bf16 ulp allowed, and is the kernel's
            # float32 dproj rounded, which is held to BWD_RTOL
            _close_max(kg, w, BWD_RTOL, name, ulp=RES_RTOL)
            f32 = gated_train_backward(*bargs[:-1], torch.float32, **k)[0]
            assert torch.equal(kg, f32.to(torch.bfloat16)), name
            kg, w = f32, gated_train_backward_reference(
                *bargs[:-1], torch.float32, **k)[0]
        _close_max(kg, w, DW_RTOL if wide and name[:2] == "dw" else BWD_RTOL,
                   name)
    if wide:
        pair, dc = _own_pair_dc(kind, got[0], h)
        _close_max(got[3], _dh0_of_pair(res, args[1], args[2], dhs, dht,
                                        pair, dc),
                   BWD_RTOL, "dh0 from the kernel's own bf16 pair and dc")
        own = gated_train_dw_reference(res, pair.contiguous(),
                                       None if dc is None
                                       else dc.contiguous())
        for kg, w, name in zip(got[1:3], own, names[1:3]):
            if w is not None:
                _close_max(kg, w, DW_RTOL, name + " of the kernel's pair")
    again = gated_train_backward(*bargs, **k)
    assert all((a is None and kg is None) or torch.equal(a, kg)
               for a, kg in zip(again, got))


@pytest.mark.parametrize("kind", sorted(GATED))
def test_gated_scan_train_autograd_on_card(cuda, kind):
    args = [None if x is None else x.requires_grad_()
            for x in _gated_case(kind, 6, 8, 32, torch.float32, cuda)]
    act = GATED[kind][1]
    ht, hs = gated_scan_train(*args, kind=kind, activation=act)
    (hs.square().sum() + ht.sum()).backward()
    got = [None if x is None else x.grad for x in args]
    cpu = [None if x is None else x.detach().cpu().requires_grad_()
           for x in args]
    ht, hs = gated_scan_train(*cpu, kind=kind, activation=act)
    (hs.square().sum() + ht.sum()).backward()
    for k, w in zip(got, cpu):
        if w is None:
            assert k is None
            continue
        scale = float(w.grad.abs().max())
        torch.testing.assert_close(k.cpu(), w.grad, rtol=0,
                                   atol=1e-2 * scale)


def test_gated_scan_refuses_grad_on_card(cuda):
    proj, w1, w2, h0 = _gated_case("gru", 4, 4, 32, torch.float32, cuda)
    w1.requires_grad_()
    with pytest.raises(RuntimeError, match="gated_scan_train"):
        gated_scan(proj, w1, w2, h0, kind="gru")
    with torch.no_grad():
        gated_scan(proj, w1, w2, h0, kind="gru")


# ---- the peephole LSTM ---------------------------------------------------

def _peep_case(t, b, h, dtype, device):
    g = torch.Generator().manual_seed(t * 1000 + b * 10 + h)
    proj = (torch.randn(t, b, 4 * h, generator=g) * 0.5).to(dtype)
    # the small sizes' scales, shrunk like 1 / sqrt(H) beyond H=400
    wh = torch.randn(h, 4 * h, generator=g) * min(0.1, 2.0 / h ** 0.5)
    peeps = [torch.randn(h, h, generator=g) * min(0.2, 4.0 / h ** 0.5)
             for _ in range(3)]
    c0 = torch.randn(b, h, generator=g) * 0.1
    h0 = torch.randn(b, h, generator=g) * 0.1
    return [x.to(device) for x in (proj, wh, *peeps, c0, h0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,h", [(5, 4, 32), (13, 33, 40), (8, 3, 64)])
def test_peephole_scan_kernel_matches_plain(cuda, t, b, h, dtype):
    args = _peep_case(t, b, h, dtype, cuda)
    before = kernels.launches["peephole_scan"]
    (ck, hk), hsk = peephole_scan(*args)
    torch.cuda.synchronize()
    assert kernels.launches["peephole_scan"] == before + 1
    (cr, hr), hsr = peephole_scan_reference(*args)
    assert hsk.dtype == dtype and hsk.shape == (t, b, h)
    _close_rel(hsk, hsr, BF16_ATOL)
    _close_rel(ck, cr, BF16_ATOL)
    _close_rel(hk, hr, BF16_ATOL)


# (1, 1, 40): one step, one row
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,h", [(5, 4, 32), (13, 33, 40), (1, 1, 40)])
def test_peephole_train_forward_kernel(cuda, t, b, h, dtype):
    _check_peep_forward(cuda, t, b, h, dtype)


# (3, 128, 1024): the training width, the weight slice resident in shared
# memory; (3, 4, 2048): streamed from L2; (3, 300, 1024): three row chunks
# of 128, 128 and 44 rows; (3, 100, 2120) and (3, 4, 4096): 64-row blocks
# (H/8 streamed 128-row blocks are not co-resident), two row chunks at
# 2120. Float32 proj: at these widths a bf16 hs value near 1 can round to
# the other neighbouring bf16 (2**-8, beyond BF16_ATOL) after float32
# sums in another order; chip_smoke.py holds bf16 hs to one bf16 ulp at
# the training shape.
PEEP_WIDE = [(3, 128, 1024), (3, 4, 2048), (3, 300, 1024), (3, 100, 2120),
             (3, 4, 4096)]


@pytest.mark.parametrize("t,b,h", PEEP_WIDE)
def test_peephole_train_forward_kernel_wide(cuda, t, b, h):
    _check_peep_forward(cuda, t, b, h, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,h", PEEP_WIDE)
def test_peephole_scan_kernel_wide(cuda, t, b, h, dtype):
    """The scan at the training kernels' wide layouts: against plain, and
    bit-equal to the training forward, whose kernel body it runs."""
    args = _peep_case(t, b, h, dtype, cuda)
    before = kernels.launches["peephole_scan"]
    (ck, hk), hsk = peephole_scan(*args)
    torch.cuda.synchronize()
    assert kernels.launches["peephole_scan"] == before + 1
    hs, _, ct, ht = peephole_train_forward(*args)
    assert torch.equal(hsk, hs) and torch.equal(ck, ct)
    assert torch.equal(hk, ht)
    (cr, hr), hsr = peephole_scan_reference(*args)
    _close_rel(hsk, hsr, BF16_ATOL,
               ulp=RES_RTOL if dtype == torch.bfloat16 else 0.0)
    _close_rel(ck, cr, BF16_ATOL)
    _close_rel(hk, hr, BF16_ATOL)


def _check_peep_forward(cuda, t, b, h, dtype):
    args = _peep_case(t, b, h, dtype, cuda)
    before = kernels.launches["peephole_train_forward"]
    hs, res, ct, ht = peephole_train_forward(*args)
    torch.cuda.synchronize()
    assert kernels.launches["peephole_train_forward"] == before + 1
    again = peephole_train_forward(*args)
    assert all(torch.equal(a, k) for a, k in zip(again, (hs, res, ct, ht)))
    # the scan runs the same kernel body: the same bits
    (cs, hs_c), hs_s = peephole_scan(*args)
    assert torch.equal(hs, hs_s) and torch.equal(ct, cs)
    assert torch.equal(ht, hs_c)
    hs_r, res_r, ct_r, ht_r = peephole_train_forward_reference(*args)
    _close_rel(hs, hs_r, BF16_ATOL)
    _close_rel(ct, ct_r, BF16_ATOL)
    _close_rel(ht, ht_r, BF16_ATOL)
    scale = max(float(res_r.float().abs().max()), 1.0)
    torch.testing.assert_close(res.float(), res_r.float(), rtol=RES_RTOL,
                               atol=BF16_ATOL * scale)


@pytest.mark.parametrize("proj_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,h", [(5, 3, 32), (13, 33, 40), (5, 33, 40),
                                   (1, 1, 40)])
def test_peephole_train_backward_kernel(cuda, t, b, h, proj_dtype):
    _check_peep_backward(cuda, t, b, h, proj_dtype)


# The forward's wide sizes, float32 dproj, as for the LSTM backward above:
# a bf16 dproj value near the max can round to the other neighbouring bf16
# after float32 sums in another order; the bf16 store is checked at the
# sizes above. dproj and dc0 stay within BWD_RTOL of the plain version.
# dh0 and dW do not always: the f32 sums flip a few bf16(dz) roundings at
# the first reverse step, the two peephole products carry them into every
# unit's dc, and by t = 0 a tenth to a fifth of bf16(dz) differs; dh0 (4H
# such terms) and dW (a sum over T*B rows, few at B=4) move by up to 2e-3
# and 3.7e-3 of their largest values on an H100 (readings of
# bench_peephole_bwd_errors.py). That is the problem's conditioning,
# not the kernel's: there the float32 plain version differs from a
# float64 twin by up to 1.4e-3 in dh0, and the per-step kernels that
# these replaced read dh0 1.3e-3 and dW 1.4e-3. So dh0 and dW are held to
# BWD_RTOL / DW_RTOL of the plain products of the kernel's own bf16 dz
# (read up to 2.2e-5 / 1.5e-6), and to WIDE_DH0_RTOL / WIDE_DW_RTOL of the
# plain version (1.3x the largest readings).
WIDE_DH0_RTOL = 2.5e-3
WIDE_DW_RTOL = 5e-3


@pytest.mark.parametrize("t,b,h", PEEP_WIDE)
def test_peephole_train_backward_kernel_streamed_and_chunked(cuda, t, b, h):
    _check_peep_backward(cuda, t, b, h, torch.float32, wide=True)


def _check_peep_backward(cuda, t, b, h, proj_dtype, wide=False):
    args = _peep_case(t, b, h, proj_dtype, cuda)
    _, res, _, _ = peephole_train_forward_reference(*args)
    g = torch.Generator().manual_seed(7)
    dhs = torch.randn(t, b, h, generator=g).to(cuda, proj_dtype)
    dct = torch.randn(b, h, generator=g).to(cuda)
    dht = torch.randn(b, h, generator=g).to(cuda)
    before = dict(kernels.launches)
    got = peephole_train_backward(res, *args[1:5], dhs, dct, dht,
                                  proj_dtype)
    torch.cuda.synchronize()
    for name in ("peephole_train_backward", "peephole_train_dw"):
        assert kernels.launches[name] == before.get(name, 0) + 1, name
    want = peephole_train_backward_reference(res, *args[1:5], dhs, dct,
                                             dht, proj_dtype)
    names = ("dproj", "dwh", "dpi", "dpf", "dpo", "dc0", "dh0")
    rtol = dict.fromkeys(names, BWD_RTOL)
    if wide:
        rtol.update(dict.fromkeys(names[1:5], WIDE_DW_RTOL),
                    dh0=WIDE_DH0_RTOL)
    for k, w, name in zip(got, want, names):
        assert k.dtype == w.dtype and k.shape == w.shape, name
        _close_max(k, w, rtol[name], name)
    if wide:
        # float32 dproj holds the kernel's dz before its bf16 rounding
        dzb = got[0].to(torch.bfloat16)
        _close_max(got[6], dzb[0].float() @ _bf16(args[1]).T, BWD_RTOL,
                   "dh0 = bf16(dz[0]) @ W_h^T")
        for k, w, name in zip(got[1:5], peephole_train_dw_reference(res, dzb),
                              names[1:5]):
            _close_max(k, w, DW_RTOL, name + " of the kernel's bf16 dz")
    again = peephole_train_backward(res, *args[1:5], dhs, dct, dht,
                                    proj_dtype)
    assert all(torch.equal(a, k) for a, k in zip(again, got))


def _close_max(got, want, rtol, msg, ulp=0.0):
    """|got - want| within rtol of max |want| (plus ulp of |want|)."""
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=ulp,
                               atol=rtol * scale, msg=msg)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def test_peephole_train_dw_kernel(cuda):
    args = _peep_case(9, 33, 40, torch.float32, cuda)
    _, res, _, _ = peephole_train_forward_reference(*args)
    g = torch.Generator().manual_seed(8)
    dz = torch.randn(9, 33, 160, generator=g).to(cuda, torch.bfloat16)
    got = peephole_train_dw(res, dz)
    torch.cuda.synchronize()
    for k, w in zip(got, peephole_train_dw_reference(res, dz)):
        assert k.shape == w.shape
        torch.testing.assert_close(k, w, rtol=0,
                                   atol=1e-5 * float(w.abs().max()))


def test_peephole_scan_train_autograd_on_card(cuda):
    args = [x.requires_grad_() for x in _peep_case(6, 8, 32, torch.float32,
                                                   cuda)]
    (ct, ht), hs = peephole_scan_train(*args)
    (hs.square().sum() + ct.sum() + ht.sum()).backward()
    got = [x.grad for x in args]
    cpu = [x.detach().cpu().requires_grad_() for x in args]
    (ct, ht), hs = peephole_scan_train(*cpu)
    (hs.square().sum() + ct.sum() + ht.sum()).backward()
    for k, w in zip(got, cpu):
        scale = float(w.grad.abs().max())
        torch.testing.assert_close(k.cpu(), w.grad, rtol=0,
                                   atol=1e-2 * scale)


def test_peephole_scan_refuses_grad_on_card(cuda):
    args = _peep_case(4, 4, 32, torch.float32, cuda)
    args[2].requires_grad_()
    with pytest.raises(RuntimeError, match="peephole_scan_train"):
        peephole_scan(*args)
    with torch.no_grad():
        peephole_scan(*args)


def test_zoneout_lstm_on_card_serves_through_lstm_scan_and_trains_without(
        cuda):
    """The zoneout LSTM's eval route is ``lstm_scan`` (bit-equal to the
    LSTM's on the same weights); its training launches no kernel."""
    from nnacousticmodeling_tpu_torch.models import get_network
    net = get_network("zoneoutlstm", 2, [32], 7, dropout=[0.2], in_dim=5,
                      scan_impl="pallas", device=cuda)
    lstm = get_network("lstm", 2, [32], 7, in_dim=5, scan_impl="pallas",
                       device=cuda)
    lstm.load_state_dict(net.state_dict())
    xs = torch.randn(3, 9, 5, device=cuda)
    before = dict(kernels.launches)
    with torch.inference_mode():
        y, _ = net.apply_sequence(xs)
        y_l, _ = lstm.apply_sequence(xs)
    assert torch.equal(y, y_l)
    assert kernels.launches["lstm_scan"] == before.get("lstm_scan", 0) + 4
    before = dict(kernels.launches)
    gen = torch.Generator(device=cuda).manual_seed(0)
    y, _ = net.apply_sequence(xs, train=True, generator=gen)
    y.sum().backward()
    torch.cuda.synchronize()
    assert dict(kernels.launches) == before
    assert net.cells[0].wh.grad is not None


# ---- feed-forward nets and ensembles ----------------------------------------
# The FF nets have no kernel of their own: their float32 products on the
# card (cuBLAS / cuDNN, TF32 off by resolve_device) match the CPU's
# within FF_ATOL (float32 sums in another order), the bf16 route within
# BF16_FF_ATOL (a value may round to the neighbouring bf16). An ensemble
# of master + K folds runs K + 1 passes of the net on the kernel route and
# matches the same ensemble on the plain recurrence within ENS_ATOL
# (chip_smoke.py's POSTERIOR_ATOL: bf16 h rounding after sums in another
# order, carried through the output layer).
FF_ATOL = 1e-4
BF16_FF_ATOL = 3e-2
ENS_ATOL = 1e-2


@pytest.mark.parametrize("kind,kw,in_dim", [
    ("ff", {}, 440), ("tdnn", dict(tdnn_ksize=(5, 5, 9, 9)), 25 * 40),
    ("tdnn", dict(tdnn_ksize=(3, 3)), 5 * 40)])
def test_ff_nets_on_card_match_cpu(cuda, kind, kw, in_dim):
    from nnacousticmodeling_tpu_torch.models import (HalfPrecisionNet,
                                                     get_network)
    units = [256] * len(kw.get("tdnn_ksize", (0, 0, 0)))
    cpu = get_network(kind, 3, units, 97, in_dim=in_dim, device="cpu",
                      seed=5, **kw)
    card = get_network(kind, 3, units, 97, in_dim=in_dim, device=cuda, **kw)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(300, in_dim, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        want = cpu.apply(x)
        got = card.apply(x.to(cuda)).cpu()
        bf_want = HalfPrecisionNet(cpu).apply(x)
        bf_got = HalfPrecisionNet(card).apply(x.to(cuda)).cpu()
    torch.testing.assert_close(got, want, atol=FF_ATOL, rtol=0)
    torch.testing.assert_close(bf_got, bf_want, atol=BF16_FF_ATOL, rtol=0)


def test_lstm_ensemble_passes_run_on_the_kernel(cuda):
    """Master + 3 folds: ``lstm_scan`` launched 4x as often as for the
    single net, every pass on the kernel; the plain recurrence gives the
    same posteriors within ENS_ATOL."""
    from unittest import mock

    from nnacousticmodeling_tpu_torch.infer import (ensemble_log_posteriors,
                                                    rnn_log_posteriors)
    from nnacousticmodeling_tpu_torch.models import (Ensemble, get_network,
                                                     get_rpl, networks,
                                                     stack_fold_params)
    nets = [get_network("lstm", 2, [64], 23, in_dim=12, scan_impl="pallas",
                        device=cuda, seed=s) for s in range(4)]
    params = [{k: v.detach().clone() for k, v in n.state_dict().items()}
              for n in nets]
    rpl = get_rpl(4, 23, device=cuda)
    ens = Ensemble(network=nets[0], rpl=rpl, num_folds=3)
    p = {"master": params[0], "folds": stack_fold_params(params[1:]),
         "rpl": {k: v.detach() + 0.1 for k, v in rpl.state_dict().items()}}
    offsets = np.array([0, 40, 77, 90, 160])
    x = np.random.default_rng(0).standard_normal((160, 12)).astype(
        np.float32)
    kernels.reset_launches()
    rnn_log_posteriors(nets[0], x, offsets, batch=4)
    single = kernels.launches["lstm_scan"]
    kernels.reset_launches()
    got = ensemble_log_posteriors(ens, p, x, offsets=offsets, batch=4)
    assert single == 2 and kernels.launches["lstm_scan"] == 4 * single
    before = dict(kernels.launches)
    with mock.patch.object(networks, "lstm_scan", lstm_scan_reference):
        plain = ensemble_log_posteriors(ens, p, x, offsets=offsets, batch=4)
    assert dict(kernels.launches) == before
    assert np.isfinite(got).all() and got.shape == (160, 23)
    np.testing.assert_allclose(got, plain, atol=ENS_ATOL, rtol=0)


# ---- fold-parallel training and CTC ----------------------------------------
# Both run the LSTM training kernels in configurations no single-net phase
# drives: K weight sets through the same kernels in one update, and both
# directions of a CTC model on inputs reversed within each length. Three
# kernel updates against three plain ones: per-fold (or per-step) losses
# within E2E_LOSS_RTOL, chip_smoke.py's bound for the same comparison;
# each parameter's change (fold-parallel) or first-step gradient (CTC)
# within E2E_CHANGE_RTOL of the plain one's largest magnitude, the bound
# of chip_smoke.py's phases 30 and 32 (there: a sum of gradients each
# built from dproj or dW, held within 1e-2 of their largest values).
E2E_LOSS_RTOL = 1e-3
E2E_CHANGE_RTOL = 1e-2
PLAIN_LSTM_TRAIN = dict(
    lstm_train_forward=lstm_train_forward_reference,
    lstm_train_backward=lstm_train_backward_reference)
PLAIN_CTC = dict(ctc_loss_forward=ctc_cuda.ctc_loss_forward_reference,
                 ctc_loss_backward=ctc_cuda.ctc_loss_backward_reference)


def test_fold_parallel_updates_on_the_kernel_match_plain(cuda):
    """3 folds of an LSTM 2x64, 3 updates (one an epoch, so each epoch's
    logged loss is one update's): the training kernels launch once a
    fold, a layer and an update, and the losses and every parameter's
    change in every fold match the plain run's."""
    import functools
    import re
    from unittest import mock

    from nnacousticmodeling_tpu_torch.models import get_network, redraw_params
    from nnacousticmodeling_tpu_torch.ops import rnn_cuda
    from nnacousticmodeling_tpu_torch.train import TrainConfig, TrainStage
    from nnacousticmodeling_tpu_torch.train.fold_parallel import (
        train_folds_parallel)
    k, layers, b, t = 3, 2, 8, 5
    rng = np.random.default_rng(0)
    # 6 utterances of 10 frames, 2 a fold: every fold's universe holds
    # b*t = 40 frames, one update an epoch
    x = rng.standard_normal((60, 12)).astype(np.float32)
    y = rng.integers(0, 11, len(x)).astype(np.int32)
    offsets = np.arange(0, 61, 10)
    utt_folds = np.arange(6) % k
    net = get_network("lstm", layers, [64], 11, in_dim=12,
                      scan_impl="pallas", device=cuda)
    inits = [redraw_params(net, s) for s in range(k)]
    cfg = TrainConfig(stages=[TrainStage(3, "momentumsgd", b, 0.1, False)],
                      bprop_len=t, seed=0, use_validation=False)
    orig = np.array2string

    def run():
        logs = []
        cfg.log = logs.append
        with mock.patch.object(np, "array2string", functools.partial(
                lambda a, precision=None: orig(a, precision=9))):
            params = train_folds_parallel(net, x, y, offsets, utt_folds, k,
                                          cfg, init_params=inits)
        losses = [np.array(m.split("loss=[")[1].split("]")[0].split(),
                           float) for m in logs if "loss=[" in m]
        return params, np.stack(losses)

    kernels.reset_launches()
    params, got = run()
    torch.cuda.synchronize()
    assert kernels.launches["lstm_train_forward"] == 3 * k * layers
    assert kernels.launches["lstm_train_backward"] == 3 * k * layers
    assert kernels.launches["lstm_train_dw"] == 3 * k * layers
    before = dict(kernels.launches)
    with mock.patch.multiple(rnn_cuda, **PLAIN_LSTM_TRAIN):
        plain, want = run()
    assert dict(kernels.launches) == before
    assert got.shape == (3, k) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=E2E_LOSS_RTOL)
    assert not torch.equal(params[0]["cells.0.wh"], params[1]["cells.0.wh"])
    for fold in range(k):
        for name, p0 in inits[fold].items():
            change = plain[fold][name] - p0.to(cuda)
            assert change.abs().max() > 0, (fold, name)
            err = (params[fold][name] - plain[fold][name]).abs().max()
            assert err <= E2E_CHANGE_RTOL * change.abs().max(), (fold, name)


def test_ctc_steps_on_the_kernel_match_plain(cuda):
    """BiRNNCTC over an LSTM 2x64: 3 Adam steps launch the training
    kernels twice a layer (both directions) a step and the CTC loss
    kernels once each a step, and the losses and the first step's
    gradients match the plain run's (the plain recurrences and CTC twins,
    by direct call)."""
    from unittest import mock

    from nnacousticmodeling_tpu_torch.models import get_network
    from nnacousticmodeling_tpu_torch.models.ctc import (
        BiRNNCTC, make_ctc_train_step)
    from nnacousticmodeling_tpu_torch.ops import rnn_cuda
    from nnacousticmodeling_tpu_torch.train import make_optimizer
    rng = np.random.default_rng(1)
    x_lens = np.array([37, 20, 29, 8])
    xs = torch.from_numpy(rng.standard_normal((4, 37, 12)).astype(
        np.float32)).to(cuda)
    y_lens = np.array([9, 5, 7, 2])
    labels = torch.from_numpy(rng.integers(1, 6, (4, 9))).to(cuda)

    def run(cuda_graph):
        model = BiRNNCTC(get_network("lstm", 2, [64], 1, in_dim=12,
                                     scan_impl="pallas", device=cuda), 5)
        step = make_ctc_train_step(model, make_optimizer(
            "adam", 1e-3, model.parameters()), cuda_graph=cuda_graph)
        losses = [float(step(xs, x_lens, labels, y_lens))]
        # the stacks' own heads are unused (no gradient)
        grads = {n: q.grad.clone() for n, q in model.named_parameters()
                 if q.grad is not None}
        losses += [float(step(xs, x_lens, labels, y_lens)) for _ in range(2)]
        return losses, grads

    kernels.reset_launches()
    got, got_grads = run(True)
    torch.cuda.synchronize()
    for name in ("lstm_train_forward", "lstm_train_backward",
                 "lstm_train_dw"):
        assert kernels.launches[name] == 3 * 2 * 2, name
    for name in ("ctc_loss_forward", "ctc_loss_backward"):
        assert kernels.launches[name] == 3, name
    before = dict(kernels.launches)
    with mock.patch.multiple(rnn_cuda, **PLAIN_LSTM_TRAIN), \
            mock.patch.multiple(ctc_cuda, **PLAIN_CTC):
        want, want_grads = run(False)
    assert dict(kernels.launches) == before
    assert np.isfinite(got).all() and got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=E2E_LOSS_RTOL)
    assert len(want_grads) == 2 * 2 * 3 + 2 and set(got_grads) == set(
        want_grads)
    for name, g in want_grads.items():
        assert g.abs().max() > 0, name
        err = (got_grads[name] - g).abs().max()
        assert err <= E2E_CHANGE_RTOL * g.abs().max(), name


# ---- the CTC loss kernels ----------------------------------------------------
# ``csrc/ctc_loss.cu`` against its plain twins (optax's recursion in
# float32): the same operations in the same order for the loss (rtol
# 1e-5), the gradient's sums in another order (within 1e-4 of the plain
# gradient's largest magnitude); two runs give the same bits (no
# atomics). Cases: repeats, label lengths 0 and 1, padded frames, an
# infeasible utterance (its loss above 1e4, finite), a frame-less one,
# an out-of-range label, more lattice positions than a block's threads.
CTC_LOSS_RTOL = 1e-5
CTC_GRAD_RTOL = 1e-4


def _ctc_case(b, t, c, s, seed, device):
    rng = np.random.default_rng(seed)
    logp = torch.log_softmax(torch.from_numpy(
        2.0 * rng.standard_normal((b, t, c)).astype(np.float32)), -1)
    labels = rng.integers(1, c, (b, s))
    if s > 1:
        labels[0, 1] = labels[0, 0]             # a repeat
    y_lens = rng.integers(max(s // 2, 1), s + 1, b)
    y_lens[-1] = 0
    if b > 2:
        y_lens[1] = 1
        labels[2, s - 1] = c + 3                # out of range (a pad)
    x_lens = rng.integers(max(t // 2, 1), t + 1, b)
    x_lens[0] = t
    if b > 4:
        x_lens[3] = max(int(y_lens[3]) // 2, 1)  # infeasible
        x_lens[-2] = 0
    return (logp.to(device), torch.from_numpy(labels).to(device),
            torch.from_numpy(x_lens).to(device),
            torch.from_numpy(y_lens).to(device))


# label rows around the warp route's slot edges (S+1 = 32, 33, 64, 65,
# 256: one, two, four and eight slots a lane), S = 300, which only the
# block route takes, and B = 300, more utterances than an H100's 132 SMs,
# so the warp route runs several warps a block
CTC_KERNEL_CASES = [(6, 17, 6, 5), (8, 60, 49, 48), (6, 400, 12, 300),
                    (4, 3, 4, 1), (6, 40, 12, 31), (6, 40, 12, 32),
                    (6, 90, 20, 63), (6, 90, 20, 64), (5, 300, 49, 255),
                    (300, 20, 12, 10)]


@pytest.mark.parametrize("route", [None, "block"])
@pytest.mark.parametrize("b,t,c,s", CTC_KERNEL_CASES)
def test_ctc_loss_kernels_match_plain(cuda, b, t, c, s, route):
    logp, labels, x_lens, y_lens = _ctc_case(b, t, c, s, 0, cuda)
    grad = torch.linspace(0.5, 1.5, b, device=cuda)
    want, want_states = ctc_cuda.ctc_loss_forward_reference(
        logp, labels, x_lens, y_lens)
    want_g = ctc_cuda.ctc_loss_backward_reference(
        logp, labels, x_lens, y_lens, want_states, grad)
    kernels.reset_launches()
    runs = []
    for _ in range(2):
        loss, states = ctc_cuda.ctc_loss_forward(logp, labels, x_lens,
                                                 y_lens, route=route)
        g = ctc_cuda.ctc_loss_backward(logp, labels, x_lens, y_lens, states,
                                       grad, route=route)
        runs.append((loss, g))
    torch.cuda.synchronize()
    suffix = "" if ctc_cuda.ctc_route(s, c, route) == "warp" else ".block"
    assert kernels.launches == {"ctc_loss_forward" + suffix: 2,
                                "ctc_loss_backward" + suffix: 2}
    loss, g = runs[0]
    assert torch.isfinite(loss).all() and torch.isfinite(g).all()
    torch.testing.assert_close(loss, want, rtol=CTC_LOSS_RTOL, atol=0)
    assert (g - want_g).abs().max() <= CTC_GRAD_RTOL * want_g.abs().max()
    valid = (torch.arange(t, device=cuda)[None, :]
             < x_lens.clamp(max=t)[:, None])
    torch.testing.assert_close(states[valid], want_states[valid],
                               rtol=CTC_LOSS_RTOL, atol=0)
    assert (g[~valid] == 0).all()
    assert torch.equal(runs[1][0], loss) and torch.equal(runs[1][1], g)
    if b > 4:
        assert loss[3] > 1e4


@pytest.mark.parametrize("b,t,c,s", [k for k in CTC_KERNEL_CASES
                                     if k[3] <= 255])   # the warp route's
def test_ctc_loss_warp_route_equals_block_route(cuda, b, t, c, s):
    """The warp route (one warp an utterance) gives the block route's
    bits: loss, the states of the valid frames, the gradient; each
    route's backward on the other's states too."""
    logp, labels, x_lens, y_lens = _ctc_case(b, t, c, s, 1, cuda)
    grad = torch.linspace(-1.0, 2.0, b, device=cuda)
    loss, states = ctc_cuda.ctc_loss_forward(logp, labels, x_lens, y_lens)
    b_loss, b_states = ctc_cuda.ctc_loss_forward(logp, labels, x_lens,
                                                 y_lens, route="block")
    g = ctc_cuda.ctc_loss_backward(logp, labels, x_lens, y_lens, states,
                                   grad)
    b_g = ctc_cuda.ctc_loss_backward(logp, labels, x_lens, y_lens, b_states,
                                     grad, route="block")
    cross = ctc_cuda.ctc_loss_backward(logp, labels, x_lens, y_lens,
                                       b_states, grad)
    torch.cuda.synchronize()
    valid = (torch.arange(t, device=cuda)[None, :]
             < x_lens.clamp(max=t)[:, None])
    assert torch.equal(loss, b_loss)
    assert torch.equal(states[valid], b_states[valid])
    assert torch.equal(g, b_g) and torch.equal(cross, g)


def test_ctc_loss_on_the_card_is_optax_not_inf(cuda):
    """``models.ctc.ctc_loss`` on CUDA tensors: the kernels' loss and
    gradient (one launch each), finite on an infeasible row, against the
    CPU route."""
    from nnacousticmodeling_tpu_torch.models.ctc import ctc_loss
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 9, 6)).astype(np.float32)
    labels = np.array([[1, 1, 2, 3], [2, 3, 0, 0], [4, 0, 0, 0]])
    x_lens, y_lens = np.array([3, 9, 7]), np.array([4, 2, 1])
    grads = []
    for dev in (cuda, torch.device("cpu")):
        lt = torch.from_numpy(logits).to(dev).requires_grad_(True)
        before = dict(kernels.launches)
        loss = ctc_loss(lt, x_lens, labels, y_lens)
        loss.backward()
        if dev.type == "cuda":
            made = {k: kernels.launches[k] - before.get(k, 0)
                    for k in ("ctc_loss_forward", "ctc_loss_backward")}
            assert made == {"ctc_loss_forward": 1, "ctc_loss_backward": 1}
        grads.append((float(loss.detach()), lt.grad.cpu()))
    (got, got_g), (want, want_g) = grads
    assert np.isfinite(got) and got > 1e4 / 3
    np.testing.assert_allclose(got, want, rtol=CTC_LOSS_RTOL)
    assert torch.isfinite(got_g).all()
    assert (got_g - want_g).abs().max() <= CTC_GRAD_RTOL * want_g.abs().max()


def test_ctc_loss_wrappers_raise(cuda):
    logp, labels, x_lens, y_lens = _ctc_case(4, 5, 6, 3, 0, cuda)
    with pytest.raises(ValueError, match="float32"):
        ctc_cuda.ctc_loss_forward(logp.double(), labels, x_lens, y_lens)
    with pytest.raises(ValueError, match="label_lengths"):
        ctc_cuda.ctc_loss_forward(logp, labels, x_lens, y_lens.cpu())
    _, states = ctc_cuda.ctc_loss_forward(logp, labels, x_lens, y_lens)
    with pytest.raises(ValueError, match="states"):
        ctc_cuda.ctc_loss_backward(logp, labels, x_lens, y_lens,
                                   states[:, :, 1:], torch.ones(4))


def _ctc_graph_run(device, cuda_graph, steps, dropout):
    from nnacousticmodeling_tpu_torch.models import get_network
    from nnacousticmodeling_tpu_torch.models.ctc import (
        BiRNNCTC, make_ctc_train_step)
    from nnacousticmodeling_tpu_torch.train import make_optimizer
    rng = np.random.default_rng(2)
    xs = torch.from_numpy(rng.standard_normal((4, 30, 12)).astype(
        np.float32)).to(device)
    x_lens = np.array([30, 21, 4, 17])           # the third is infeasible
    labels = rng.integers(1, 6, (4, 8))
    y_lens = np.array([8, 5, 6, 3])
    model = BiRNNCTC(get_network("lstm", 2, [64], 1, in_dim=12,
                                 dropout=[dropout], scan_impl="pallas",
                                 device=device), 5)
    step = make_ctc_train_step(model, make_optimizer(
        "adam", 1e-3, model.parameters()), cuda_graph=cuda_graph)
    gen = torch.Generator(device=device).manual_seed(7)
    kernels.reset_launches()
    losses = torch.stack([step(xs, x_lens, labels, y_lens, gen)
                          for _ in range(steps)]).cpu()
    torch.cuda.synchronize()
    return (losses, {k: v.detach().cpu() for k, v in
                     model.state_dict().items()}, dict(kernels.launches),
            step, (xs, x_lens, labels, y_lens))


@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_ctc_graph_steps_equal_direct_calls(cuda, dropout):
    """``make_ctc_train_step``: 4 steps by graph replay (the first a
    direct call, the second the capture) against 4 direct calls, one
    seed and one init: losses, params and launch counts bit-equal; every
    loss finite though one utterance cannot fit; a call with another
    generator raises."""
    got, got_p, got_l, step, batch = _ctc_graph_run(cuda, True, 4, dropout)
    want, want_p, want_l, _, _ = _ctc_graph_run(cuda, False, 4, dropout)
    assert torch.isfinite(got).all() and torch.equal(got, want)
    for name, v in want_p.items():
        assert torch.isfinite(got_p[name]).all(), name
        assert torch.equal(got_p[name], v), name
    assert got_l == want_l
    assert got_l["ctc_loss_forward"] == got_l["ctc_loss_backward"] == 4
    assert got_l["lstm_train_forward"] == 4 * 2 * 2
    with pytest.raises(ValueError, match="another generator"):
        step(*batch, torch.Generator(device=cuda).manual_seed(7))


# Six (T, S) shapes of one CTC step function, largest first, stepped in an
# interleaved order: each shape's first call is direct, its second
# captures, the rest replay.
CTC_SHAPES = {"A": (400, 20), "B": (370, 19), "C": (340, 18),
              "D": (310, 17), "E": (280, 16), "F": (250, 15)}
CTC_ORDER = "ABACBDCEDFEFABCDEF"


def _ctc_shapes_run(device, cuda_graph, order):
    """``make_ctc_train_step`` over an LSTM 2x256 at B=32 through
    ``order`` (keys of CTC_SHAPES): the losses, the final params and the
    reserved bytes after each shape's second call (its capture)."""
    from nnacousticmodeling_tpu_torch.models import get_network
    from nnacousticmodeling_tpu_torch.models.ctc import (
        BiRNNCTC, make_ctc_train_step)
    from nnacousticmodeling_tpu_torch.train import make_optimizer
    rng = np.random.default_rng(3)
    xs = torch.from_numpy(rng.standard_normal((32, 400, 12)).astype(
        np.float32)).to(device)
    x_lens = rng.integers(200, 401, 32)
    labels = rng.integers(1, 6, (32, 20))
    y_lens = rng.integers(10, 21, 32)
    model = BiRNNCTC(get_network("lstm", 2, [256], 1, in_dim=12,
                                 dropout=[0.2], scan_impl="pallas",
                                 device=device, seed=5), 5, seed=5)
    step = make_ctc_train_step(model, make_optimizer(
        "adam", 1e-3, model.parameters()), cuda_graph=cuda_graph)
    gen = torch.Generator(device=device).manual_seed(9)
    losses, reserved, calls = [], [], {}
    for key in order:
        t, s = CTC_SHAPES[key]
        losses.append(step(xs[:, :t], np.minimum(x_lens, t), labels[:, :s],
                           np.minimum(y_lens, s), gen))
        calls[key] = calls.get(key, 0) + 1
        if calls[key] == 2:
            torch.cuda.synchronize()
            reserved.append(torch.cuda.memory_reserved(device))
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return torch.stack(losses).cpu(), params, reserved


def test_ctc_step_graphs_share_one_memory_pool(cuda):
    """The graphs of one CTC step function share one memory pool: after
    six shapes' captures (largest first, interleaved), the memory the run
    reserved is within 1.25x of what the largest shape alone reserved
    (each graph with a pool of its own held about one more largest
    shape's activations a shape)."""
    import gc

    def reserved_by(order):
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved(cuda)
        _, _, reserved = _ctc_shapes_run(cuda, True, order)
        return [r - base for r in reserved]

    alone = reserved_by("AAA")[-1]
    six = reserved_by(CTC_ORDER)
    assert len(six) == 6 and alone > 0
    assert six[-1] <= 1.25 * alone, (
        f"reserved after each capture {[r / 2**20 for r in six]} MiB, the "
        f"largest shape alone {alone / 2**20} MiB")


def test_ctc_step_graphs_interleaved_equal_direct_calls(cuda):
    """Six shapes stepped in an interleaved order by graph replay (one
    shared pool) against the same calls made directly: losses and params
    bit-equal, so no replay read memory that another shape's replay
    overwrote."""
    got, got_p, _ = _ctc_shapes_run(cuda, True, CTC_ORDER)
    want, want_p, _ = _ctc_shapes_run(cuda, False, CTC_ORDER)
    assert torch.isfinite(got).all() and torch.equal(got, want)
    for name, v in want_p.items():
        assert torch.equal(got_p[name], v), name


# ---- the training update as one CUDA graph ----------------------------------
# ``train_network`` captures each stage's update once, after the stage's
# first update (a direct call), and replays it for every later update. On
# one seed and one init the graph run's params and history are bit-equal
# to the direct-call run's (``cuda_graph=False``), dropout and zoneout
# masks drawn (the generator registered with the graph draws the direct
# call's masks), and ``kernels.launches`` counts the same launches. The
# TDNN's cuDNN convolutions run with ``cudnn.deterministic`` in both runs
# (the default backward algorithms may sum with atomics).
GRAPH_CASES = [("lstm", "float32", "momentumsgd", [0.2]),
               ("lstm", "bfloat16", "adam", [0.2]),
               ("gru", "float32", "adam", [0.2]),
               ("mgrurelur", "float32", "momentumsgd", [0.2]),
               ("peepholelstm", "float32", "adam", [0.2]),
               ("zoneoutlstm", "float32", "momentumsgd", [0.3, 0.2]),
               ("zoneoutdropoutlstm", "bfloat16", "adam", [0.2, 0.3, 0.2]),
               ("ff", "float32", "momentumsgd", [0.2]),
               ("ff", "bfloat16", "adam", [0.2]),
               ("tdnn", "float32", "adam", [0.2])]


def _graph_data(net):
    """Three updates an epoch: 8 streams x bprop 5 over 120 frames, or
    batches of 32 of 96 frames (the TDNN's a 5-frame window of 12)."""
    rng = np.random.default_rng(4)
    d = 60 if net == "tdnn" else 12
    n = 120 if net not in ("ff", "tdnn") else 96
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = rng.integers(0, 11, n).astype(np.int32)
    offsets = np.array([0, 30, 64, 90, n])
    return x, y, offsets


def _graph_run(device, net, dtype, optimizer, dropout, cuda_graph,
               stages=None, on_net=None, **kw):
    from nnacousticmodeling_tpu_torch.models import get_network
    from nnacousticmodeling_tpu_torch.train import (
        TrainConfig, TrainStage, train_network)
    x, y, offsets = _graph_data(net)
    ff = net in ("ff", "tdnn")
    model = get_network(net, 2, [32, 32] if net == "tdnn" else [64], 11,
                        dropout=dropout, tdnn_ksize=(3, 3),
                        in_dim=x.shape[1], scan_impl="pallas", device=device)
    if on_net is not None:
        on_net(model)
    stages = stages or [dict(epoch=2, optimizer=optimizer,
                             batch_size=32 if ff else 8, lr=1e-2,
                             early_stopping=False)]
    cfg = TrainConfig(stages=[TrainStage(**s) for s in stages], bprop_len=5,
                      seed=0, log=None, compute_dtype=dtype,
                      use_validation=kw.pop("use_validation", False), **kw)
    kernels.reset_launches()
    with torch.backends.cudnn.flags(deterministic=True):
        res = train_network(model, x, y, cfg,
                            offsets=None if ff else offsets,
                            x_dev=x[:60], y_dev=y[:60], device=device,
                            cuda_graph=cuda_graph)
    torch.cuda.synchronize()
    return res, dict(kernels.launches)


def _assert_same_training(got, want):
    assert len(got.history) == len(want.history)
    for hg, hw in zip(got.history, want.history):
        for k, v in hw.items():
            if k != "elapsed_time":
                assert hg[k] == v, k
    assert got.params.keys() == want.params.keys()
    for k, v in want.params.items():
        assert torch.equal(got.params[k], v), k


@pytest.mark.parametrize("net,dtype,optimizer,dropout", GRAPH_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in GRAPH_CASES])
def test_graph_updates_equal_direct_calls(cuda, net, dtype, optimizer,
                                          dropout):
    """Two epochs of three updates (one direct call, one capture, five
    replays) against six direct calls: the same params, history and
    kernel launch counts, masks drawn; the params moved."""
    got, got_launches = _graph_run(cuda, net, dtype, optimizer, dropout,
                                   True)
    want, want_launches = _graph_run(cuda, net, dtype, optimizer, dropout,
                                     False)
    _assert_same_training(got, want)
    assert got_launches == want_launches
    if net in ("lstm", "gru", "mgrurelur", "peepholelstm"):
        assert min(got_launches.values()) == 6 * 2, got_launches
    x, _, _ = _graph_data(net)
    from nnacousticmodeling_tpu_torch.models import get_network
    init = get_network(net, 2, [32, 32] if net == "tdnn" else [64], 11,
                       dropout=dropout, tdnn_ksize=(3, 3), in_dim=x.shape[1],
                       device="cpu").state_dict()
    assert all(not torch.equal(got.params[k].cpu(), v)
               for k, v in init.items() if v.dim() == 2)


def test_graph_epoch_is_one_graph_launch_an_update(cuda):
    """The second epoch, profiled (from the hook after the first to the
    hook after it): three ``cudaGraphLaunch`` calls; kernels launched from
    the host only the epoch's own few (the step counter's reset, the two
    means) and, before each replay, PyTorch's fills of the registered
    generators' seed and offset (two a generator: the engine's and the
    default one), against hundreds an epoch by direct calls; the training
    kernels' device runs one forward and one backward a layer an
    update."""
    from torch.profiler import ProfilerActivity, profile

    def epoch2(cuda_graph):
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

        def hook(stage, epoch):
            torch.cuda.synchronize()
            (prof.start if epoch == 1 else prof.stop)()

        _graph_run(cuda, "lstm", "float32", "momentumsgd", [0.2],
                   cuda_graph, epoch_hook=hook)
        events = prof.key_averages()

        def count(pred):
            return sum(ev.count for ev in events if pred(ev.key))

        host = count(lambda k: k in (
            "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel"))
        return count, host

    count, host_launches = epoch2(True)
    _, direct_launches = epoch2(False)
    assert count(lambda k: k == "cudaGraphLaunch") == 3
    assert host_launches <= 3 + 3 * 2 * 2, host_launches
    assert direct_launches >= 100, direct_launches
    assert count(lambda k: "lstm_train_fwd_persistent" in k) == 3 * 2
    assert count(lambda k: "lstm_train_bwd_persistent" in k) == 3 * 2


def test_graph_trains_reloaded_tensors(cuda, tmp_path):
    """A fixed-epoch stage whose best validation model is not its last
    (reloaded in place at the stage's end) followed by a second stage,
    and a run killed after its first epoch and resumed from its
    snapshot: each bit-equal to the direct-call run."""
    stages = [dict(epoch=3, optimizer="momentumsgd", batch_size=8, lr=0.5,
                   early_stopping=False),
              dict(epoch=1, optimizer="adam", batch_size=8, lr=1e-2,
                   early_stopping=False)]
    got, _ = _graph_run(cuda, "gru", "float32", None, [0.2], True,
                        stages=stages, use_validation=True)
    want, _ = _graph_run(cuda, "gru", "float32", None, [0.2], False,
                         stages=stages, use_validation=True)
    _assert_same_training(got, want)
    val = [h["validation/main/loss"] for h in got.history[:3]]
    assert int(np.argmin(val)) < 2, val

    class Crash(Exception):
        pass

    def crash(stage, epoch):
        if (stage, epoch) == (0, 1):
            raise Crash

    snap = str(tmp_path / "snap.npz")
    with pytest.raises(Crash):
        _graph_run(cuda, "gru", "float32", None, [0.2], True, stages=stages,
                   use_validation=True, snapshot_path=snap, epoch_hook=crash)
    res, _ = _graph_run(cuda, "gru", "float32", None, [0.2], True,
                        stages=stages, use_validation=True,
                        snapshot_path=snap, resume_snapshot=True)
    assert len(res.history) == 3
    for hr, hw in zip(res.history, want.history[1:]):
        for k in ("stage", "epoch", "main/loss", "validation/main/loss"):
            assert hr[k] == hw[k], k
    for k, v in want.params.items():
        assert torch.equal(res.params[k], v), k


def test_graph_refuses_replaced_parameter_and_failed_capture(cuda,
                                                             monkeypatch):
    """A parameter rebound between epochs (the graph would go on training
    the old storage) raises at the next epoch; a capture that fails makes
    ``train_network`` raise, with no eager fallback."""
    from nnacousticmodeling_tpu_torch.train import engine
    nets = []

    def rebind(stage, epoch):
        for p in nets[0].parameters():
            p.data = p.data.clone()

    with pytest.raises(RuntimeError, match="replaced since the update"):
        _graph_run(cuda, "lstm", "float32", "momentumsgd", [0.0], True,
                   on_net=nets.append, epoch_hook=rebind)

    def fail(step, generator):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(engine, "_capture_update", fail)
    with pytest.raises(RuntimeError, match="capturing the update as a CUDA "
                                           "graph failed.*capture refused"):
        _graph_run(cuda, "lstm", "float32", "momentumsgd", [0.0], True)


@pytest.mark.parametrize("name", ["sgd", "momentumsgd", "adam"])
def test_capturable_optimizer_steps_equal_host_steps(cuda, name):
    """The engine's optimizer on the card (Adam ``capturable``: its step
    count and bias corrections on the device) against the host optimizer
    on CPU params, which ``test_torch_train.py`` holds to optax, within
    that test's 1e-6."""
    from nnacousticmodeling_tpu_torch.train import make_optimizer
    rng = np.random.default_rng(2)
    p0 = rng.standard_normal((5, 3)).astype(np.float32)
    grads = [rng.standard_normal((5, 3)).astype(np.float32)
             for _ in range(3)]
    p_host = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    p_card = torch.nn.Parameter(torch.from_numpy(p0.copy()).to(cuda))
    host = make_optimizer(name, 0.05, [p_host])
    card = make_optimizer(name, 0.05, [p_card])
    assert card.param_groups[0].get("capturable", False) == (name == "adam")
    assert not host.param_groups[0].get("capturable", False)
    for g in grads:
        p_host.grad = torch.from_numpy(g)
        p_card.grad = torch.from_numpy(g).to(cuda)
        host.step()
        card.step()
        np.testing.assert_allclose(p_card.detach().cpu().numpy(),
                                   p_host.detach().numpy(), rtol=1e-6,
                                   atol=1e-6)


# ---- fold-parallel training's update as one CUDA graph ----------------------
# ``train_folds_parallel`` captures the update of each (stage, fold count)
# once, after its first update (a direct call), replays it for every later
# update, and captures anew after a stop compacts the folds and at each
# stage boundary. On one seed the graph run's log (every fold's train and
# dev loss at full precision, the compaction lines), params and launch
# counts are the direct-call run's (``cuda_graph=False``), masks drawn.
# The data make one fold stop: fold 2 trains on class 1 alone against a
# dev set of class 0, the others on both classes.
FOLD_ES = dict(epoch=4, optimizer="momentumsgd", batch_size=8, lr=0.01,
               early_stopping=True)
FOLD_FIXED = dict(epoch=1, optimizer="adam", batch_size=8, lr=0.0,
                  early_stopping=False)
FOLD_GRAPH_CASES = [
    ("lstm", 4, 1024, [0.2], [FOLD_ES, FOLD_FIXED]),
    ("zoneoutlstm", 2, 64, [0.3, 0.2], [FOLD_ES, FOLD_FIXED]),
    # adam's state carried over the compaction into the next capture
    ("ff", 2, 64, [0.2], [dict(FOLD_ES, optimizer="adam", batch_size=32),
                          dict(FOLD_FIXED, optimizer="momentumsgd",
                               lr=0.01, batch_size=32)]),
]


def _fold_graph_data():
    """6 utterances of 30 frames, utterance u in fold u % 3: every fold's
    universe is 120 frames, three updates an epoch (8 streams x bprop 5,
    or batches of 32). Fold 2's universe (folds 0 and 1) is class 1, fold
    2's own utterances class 0, the dev set class 0."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((180, 12)).astype(np.float32)
    offsets = np.arange(0, 181, 30)
    y = np.zeros(180, np.int32)
    for u in range(6):
        if u % 3 != 2:
            y[offsets[u]:offsets[u + 1]] = 1
    x_dev = rng.standard_normal((60, 12)).astype(np.float32)
    return x, y, offsets, np.arange(6) % 3, x_dev, np.zeros(60, np.int32)


def _fold_graph_run(device, net, layers, units, dropout, stages, cuda_graph,
                    use_validation=True, on_line=None):
    """(log lines without their seconds, the 3 param maps, launch
    counts) of one ``train_folds_parallel`` run, seed 0."""
    import functools
    import re
    from unittest import mock

    from nnacousticmodeling_tpu_torch.models import get_network
    from nnacousticmodeling_tpu_torch.train import TrainConfig, TrainStage
    from nnacousticmodeling_tpu_torch.train.fold_parallel import (
        train_folds_parallel)
    x, y, offsets, utt_folds, x_dev, y_dev = _fold_graph_data()
    model = get_network(net, layers, [units], 11, dropout=dropout,
                        in_dim=12, scan_impl="pallas", device=device)
    lines = []

    def log(msg):
        lines.append(msg)
        if on_line is not None:
            on_line(msg)

    cfg = TrainConfig(stages=[TrainStage(**s) for s in stages], bprop_len=5,
                      seed=0, log=log, use_validation=use_validation)
    orig = np.array2string
    kernels.reset_launches()
    with mock.patch.object(np, "array2string", functools.partial(
            lambda a, precision=None: orig(a, precision=9,
                                           max_line_width=10 ** 6))):
        params = train_folds_parallel(model, x, y, offsets, utt_folds, 3,
                                      cfg, x_dev=x_dev, y_dev=y_dev,
                                      eval_batch=8, cuda_graph=cuda_graph)
    torch.cuda.synchronize()
    return ([re.sub(r" \([0-9.]+s\)", "", m) for m in lines], params,
            dict(kernels.launches))


@pytest.mark.parametrize("net,layers,units,dropout,stages", FOLD_GRAPH_CASES,
                         ids=[c[0] for c in FOLD_GRAPH_CASES])
def test_fold_graph_updates_equal_direct_calls(cuda, net, layers, units,
                                               dropout, stages):
    """An early-stopping stage in which fold 2 stops (a compaction, so a
    second capture), then a fixed-epoch stage (a third): every log line,
    every fold's params and the launch counts bit-equal to the direct
    calls'; the LSTM training kernels launched once a fold, a layer and
    an update."""
    import re
    got_log, got, got_launches = _fold_graph_run(
        cuda, net, layers, units, dropout, stages, True)
    want_log, want, want_launches = _fold_graph_run(
        cuda, net, layers, units, dropout, stages, False)
    assert got_log == want_log
    assert any("compacted to folds [0, 1]" in m for m in got_log), got_log
    assert got_launches == want_launches
    for g, w in zip(got, want):
        for k, v in w.items():
            assert torch.equal(g[k], v), k
    if net == "lstm":
        fold_updates = sum(
            3 * len(m.group(1).split(","))
            for m in map(re.compile(r"folds=\[(.*?)\] loss").search, got_log)
            if m)
        for name in ("lstm_train_forward", "lstm_train_backward",
                     "lstm_train_dw"):
            assert got_launches[name] == fold_updates * layers, name


def test_fold_graph_epoch_is_one_graph_launch_an_update(cuda):
    """The second epoch of 3 folds of an LSTM 2x64 (no validation),
    profiled from the first epoch's log line to its own: three
    ``cudaGraphLaunch`` calls, the training kernels' device runs one
    forward and one backward a fold, a layer and an update, and far fewer
    host launches than the same epoch by direct calls."""
    from torch.profiler import ProfilerActivity, profile

    def epoch2(cuda_graph):
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        seen = []

        def on_line(msg):
            if "loss=" in msg:
                torch.cuda.synchronize()
                seen.append(msg)
                if len(seen) in (1, 2):
                    (prof.start if len(seen) == 1 else prof.stop)()

        _fold_graph_run(cuda, "lstm", 2, 64, [0.2],
                        [dict(FOLD_ES, epoch=3, early_stopping=False)],
                        cuda_graph, use_validation=False, on_line=on_line)
        events = prof.key_averages()

        def count(pred):
            return sum(ev.count for ev in events if pred(ev.key))

        host = count(lambda k: k in (
            "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel"))
        return count, host

    count, host_launches = epoch2(True)
    _, direct_launches = epoch2(False)
    assert count(lambda k: k == "cudaGraphLaunch") == 3
    assert count(lambda k: "lstm_train_fwd_persistent" in k) == 3 * 3 * 2
    assert count(lambda k: "lstm_train_bwd_persistent" in k) == 3 * 3 * 2
    assert direct_launches >= 100, direct_launches
    assert 4 * host_launches < direct_launches, (host_launches,
                                                 direct_launches)


def test_fold_graph_failed_capture_raises(cuda, monkeypatch):
    """A capture that fails makes ``train_folds_parallel`` raise, naming
    itself and the cause, with no eager fallback."""
    from nnacousticmodeling_tpu_torch.train import engine

    def fail(step, generator):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(engine, "_capture_update", fail)
    with pytest.raises(RuntimeError, match="train_folds_parallel: capturing "
                       "the update as a CUDA graph failed.*capture refused"):
        _fold_graph_run(cuda, "lstm", 2, 64, [0.0], [FOLD_FIXED], True)
