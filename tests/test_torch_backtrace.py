"""The port's Viterbi backtrace against the JAX package's.

``decoder/viterbi_backtrace.py`` holds the walk every backend shares:
the ``viterbi_backtrace`` CUDA kernel for CUDA tensors and its plain
version for CPU tensors. Here the plain walk, reached through the
decoder's ``_collapsed_backtrace`` / ``_pallas_backtrace`` /
``_device_backtrace``, must give segs (padding included) and counts
BIT-equal to ``jax.vmap`` of the JAX decoder's methods of the same names
on the same numpy rows: the forwards' own rows, and adversarial rows no
forward produces (entry times at or after the hop's frame, ties in the
last end row, lengths 0, 1, 2 and T, both cube orders, a pack factor
above ``TIME_PACK``). The kernel's int32 tables must equal the plain
walk's int64 ones (and the JAX decoder's), and CPU tensors never build
or launch the kernel. ``kernel_model``, the numpy transcription of the
kernel's hop (``test_torch_backtrace_model.py``), must give the same bits
on the same rows on each of the kernel's routes, pack factors 2048 to
8192 included. The kernel itself is held to the plain walk on the card
(``test_torch_cuda.py``).
"""

import jax
import numpy as np
import pytest
import torch

from nnacousticmodeling_tpu.decoder.image import make_synthetic_image
from nnacousticmodeling_tpu.decoder.viterbi import (
    ViterbiDecoder as JaxDecoder,
)
from nnacousticmodeling_tpu_torch import kernels
from nnacousticmodeling_tpu_torch.decoder import viterbi_backtrace as vbt
from nnacousticmodeling_tpu_torch.decoder.viterbi import (
    TIME_PACK,
    ViterbiDecoder,
)

from test_torch_backtrace_model import kernel_model
from test_torch_viterbi import _to_bac

IMAGES = {
    "tied4_abc": lambda: make_synthetic_image(
        num_phones=4, num_states=14, seed=6, pdf_tied_transitions=True),
    "tied5_bac": lambda: _to_bac(make_synthetic_image(
        num_phones=5, num_states=17, seed=7, pdf_tied_transitions=True)),
}
KW = dict(pip=5.0, lmw=1.5)
T_SHORT = 13
#: the padded T, an empty utterance, the 1- and 2-frame degenerate cases
LENGTHS = (T_SHORT, 0, 1, 2, 7, 11)
#: backend -> the backtrace method both decoders name
WALKS = {"collapsed": "_collapsed_backtrace", "pallas": "_pallas_backtrace",
         "xla": "_device_backtrace"}


def _pair(name, backend, beam=None):
    img = IMAGES[name]()
    port = ViterbiDecoder(img, backend=backend, beam=beam, device="cpu",
                          **KW)
    ref = JaxDecoder(img, backend=backend, beam=beam, **KW)
    assert port.backend == ref.backend == backend
    return img, port, ref


def _walk_both(port, ref, backend, packed, end, lens):
    """(port segs, counts), (JAX segs, counts) as numpy on the same rows."""
    method = WALKS[backend]
    got = getattr(port, method)(torch.from_numpy(packed),
                                torch.from_numpy(end), torch.from_numpy(lens))
    want = jax.jit(jax.vmap(getattr(ref, method)))(packed, end, lens)
    return ([np.asarray(a) for a in got], [np.asarray(a) for a in want])


def _tables_of(port, backend):
    return {"collapsed": port._bt_collapsed, "pallas": port._bt_cube,
            "xla": port._bt_scan}[backend]


def _model_each_route(port, backend, packed, end, lens, pack, want):
    """The kernel's numpy transcription on each route equals ``want``
    (the collapsed modes' one; the lane map's two)."""
    tables = _tables_of(port, backend)
    assert vbt.backtrace_route(tables) == "shared"
    routes = vbt.backtrace_routes(tables)
    assert routes == (("shared", "global") if backend != "collapsed"
                      else ("shared",))
    for route in routes:
        _assert_bit_equal(kernel_model(tables, packed, end, lens, pack,
                                       route), want)


def _assert_bit_equal(got, want):
    """segs whole (the zero padding past each count included), counts."""
    (segs, counts), (want_segs, want_counts) = got, want
    assert segs.dtype == np.int32 and counts.dtype == np.int64
    assert segs.shape == want_segs.shape
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(segs, want_segs)


def _forward_rows(port, backend, lp, lens):
    lp_t, lens_t = torch.from_numpy(lp), torch.from_numpy(lens)
    if backend == "collapsed":
        out = port._collapsed_fwd.forward(lp_t, lens_t)
    elif backend == "pallas":
        out = port._pallas_fwd.forward(lp_t, lens_t)
    else:
        out = port._forward_scan(lp_t)
    return [np.ascontiguousarray(a.numpy()) for a in out]


@pytest.mark.parametrize("beam", [None, 3.0])
@pytest.mark.parametrize("backend", ["collapsed", "pallas", "xla"])
@pytest.mark.parametrize("name", ["tied4_abc", "tied5_bac"])
def test_plain_walk_equals_jax_on_forward_rows(name, backend, beam):
    img, port, ref = _pair(name, backend, beam)
    rng = np.random.default_rng(len(name) + len(backend))
    lens = np.asarray(LENGTHS, np.int32)
    lp = np.log(rng.dirichlet(np.ones(img.num_states),
                              size=(len(lens), T_SHORT))).astype(np.float32)
    packed, end = _forward_rows(port, backend, lp, lens)
    got, want = _walk_both(port, ref, backend, packed, end, lens)
    _assert_bit_equal(got, want)
    assert got[1][1] == 0 and (got[1][[0, 4, 5]] > 0).all()


@pytest.mark.parametrize("backend", ["collapsed", "pallas", "xla"])
@pytest.mark.parametrize("name", ["tied4_abc", "tied5_bac"])
def test_kernel_model_equals_plain_and_jax_on_forward_rows(name, backend):
    """The kernel's hop (shift and mask, the (b, c) carry, 32-bit tri, the
    table of each route) on the forwards' own rows, beam or not."""
    for beam in (None, 3.0):
        img, port, ref = _pair(name, backend, beam)
        rng = np.random.default_rng(len(name) + len(backend))
        lens = np.asarray(LENGTHS, np.int32)
        lp = np.log(rng.dirichlet(np.ones(img.num_states), size=(
            len(lens), T_SHORT))).astype(np.float32)
        packed, end = _forward_rows(port, backend, lp, lens)
        got, want = _walk_both(port, ref, backend, packed, end, lens)
        _assert_bit_equal(got, want)
        pack = (port._collapsed_for_t(T_SHORT).pack if backend == "collapsed"
                else port._time_pack_for(T_SHORT))
        _model_each_route(port, backend, packed, end, lens, pack, want)


def _adversarial_rows(rng, port, backend, t, lens):
    """Packed rows and end scores no forward makes: random predecessors,
    entry times anywhere in [-1, t'] of each frame t' (about a third at
    or after it, the guard's case), and end rows drawn from three values
    so the last row of every utterance holds ties."""
    P = port.image.num_phones
    lanes = {"collapsed": lambda: port._collapsed_fwd.L,
             "pallas": lambda: port._pallas_fwd.B,
             "xla": lambda: port.image.num_biphones}[backend]()
    if backend == "collapsed":
        pack = port._collapsed_for_t(t).pack
        top = P                                  # a* < P
    else:
        pack = port._time_pack_for(t)
        top = port.image.num_triphones           # tri < T3
    u = len(lens)
    frame = np.arange(t)[None, :, None]
    t_entry = rng.integers(-1, frame + 1, size=(u, t, lanes))
    late = rng.random((u, t, lanes)) < 0.35
    t_entry = np.where(late, frame + rng.integers(0, 3, (u, t, lanes)),
                       t_entry)
    t_entry = np.minimum(t_entry, pack - 2)
    pred = rng.integers(0, top, size=(u, t, lanes))
    packed = (pred * pack + t_entry + 1).astype(np.int32)
    end = rng.choice(np.asarray([-3.0, -1.5, -1.5], np.float32),
                     size=(u, t, P))
    last = end[np.arange(u), np.maximum(lens - 1, 0)]
    assert ((last == last.max(axis=1, keepdims=True)).sum(axis=1) > 1).any()
    return packed, np.ascontiguousarray(end), pack


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("backend", ["collapsed", "pallas", "xla"])
@pytest.mark.parametrize("name", ["tied4_abc", "tied5_bac"])
def test_plain_walk_equals_jax_on_adversarial_rows(name, backend, seed):
    img, port, ref = _pair(name, backend)
    rng = np.random.default_rng(100 + 10 * seed + len(backend))
    lens = np.asarray(LENGTHS, np.int32)
    packed, end, pack = _adversarial_rows(rng, port, backend, T_SHORT, lens)
    assert pack == TIME_PACK
    got, want = _walk_both(port, ref, backend, packed, end, lens)
    _assert_bit_equal(got, want)
    # the guard ended some walk: a segment whose entry is at or after
    # its own last frame
    segs, counts = got
    assert any((segs[u, :k, 0] >= segs[u, :k, 1]).any()
               for u, k in enumerate(counts))


@pytest.mark.parametrize("backend", ["collapsed", "pallas", "xla"])
@pytest.mark.parametrize("name", ["tied4_abc", "tied5_bac"])
def test_kernel_model_equals_plain_and_jax_on_adversarial_rows(name,
                                                                backend):
    """Random predecessors, entries at or after their frame, ties in the
    last end rows and NaN in some, lengths 0, 1, 2 and T."""
    img, port, ref = _pair(name, backend)
    for seed in (0, 1):
        rng = np.random.default_rng(200 + 10 * seed + len(backend))
        lens = np.asarray(LENGTHS, np.int32)
        packed, end, pack = _adversarial_rows(rng, port, backend, T_SHORT,
                                              lens)
        end[2, lens[2] - 1, rng.integers(0, img.num_phones)] = np.nan
        got, want = _walk_both(port, ref, backend, packed, end, lens)
        _assert_bit_equal(got, want)
        _model_each_route(port, backend, packed, end, lens, pack, want)


@pytest.mark.parametrize("backend", ["collapsed", "pallas", "xla"])
@pytest.mark.parametrize("name", ["tied4_abc", "tied5_bac"])
def test_plain_walk_equals_jax_above_time_pack(name, backend):
    """T = 2100 frames: both packages grow the pack factor to 4096."""
    img, port, ref = _pair(name, backend)
    t = 2100
    rng = np.random.default_rng(7 + len(backend))
    lens = np.asarray([t, 0, 1, 2, 2050, 1999], np.int32)
    packed, end, pack = _adversarial_rows(rng, port, backend, t, lens)
    assert pack == 2 * TIME_PACK
    got, want = _walk_both(port, ref, backend, packed, end, lens)
    _assert_bit_equal(got, want)
    _model_each_route(port, backend, packed, end, lens, pack, want)


@pytest.mark.parametrize("backend", ["collapsed", "xla"])
def test_kernel_model_equals_plain_and_jax_at_pack_8192(backend):
    """T = 4100 frames: both packages grow the pack factor to 8192."""
    img, port, ref = _pair("tied5_bac", backend)
    t = 4100
    rng = np.random.default_rng(81 + len(backend))
    lens = np.asarray([t, 0, 1, 2, 4097], np.int32)
    packed, end, pack = _adversarial_rows(rng, port, backend, t, lens)
    assert pack == 4 * TIME_PACK
    got, want = _walk_both(port, ref, backend, packed, end, lens)
    _assert_bit_equal(got, want)
    _model_each_route(port, backend, packed, end, lens, pack, want)


@pytest.mark.parametrize("backend", ["collapsed", "pallas", "xla"])
@pytest.mark.parametrize("name", ["tied4_abc", "tied5_bac"])
def test_kernel_tables_equal_plain_and_jax_tables(name, backend):
    """int32 copies of the int64 tables the plain walk indexes with, the
    JAX decoder's maps, the mode of the image's cube order."""
    img, port, ref = _pair(name, backend)
    tables = {"collapsed": port._bt_collapsed, "pallas": port._bt_cube,
              "xla": port._bt_scan}[backend]
    for t32, t64 in ((tables.end_map32, tables.end_map),
                     (tables.step_map32, tables.step_map)):
        assert t32.dtype == torch.int32 and t64.dtype == torch.int64
        assert t32.is_contiguous()
        np.testing.assert_array_equal(t32.numpy(), t64.numpy())
    if backend == "collapsed":
        want = (ref._end_idxs, ref._collapsed_fwd.bi2lane)
        order = vbt.COLLAPSED_BAC if name.endswith("bac") else \
            vbt.COLLAPSED_ABC
    elif backend == "pallas":
        want = (ref._pallas_fwd.end_lane, ref._pallas_fwd.bi_in_lane)
        order = vbt.LANES
    else:
        want = (ref._end_idxs, ref._biphone_in)
        order = vbt.LANES
    assert tables.mode == order and tables.num_phones == img.num_phones
    np.testing.assert_array_equal(tables.end_map32.numpy(),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal(tables.step_map32.numpy(),
                                  np.asarray(want[1]))


@pytest.mark.parametrize("backend", ["collapsed", "pallas", "xla"])
def test_cpu_tensors_never_build_or_launch_the_kernel(monkeypatch, backend):
    def refuse(name):
        raise AssertionError(f"kernels.load({name!r}) on CPU tensors")

    monkeypatch.setattr(kernels, "load", refuse)
    kernels.reset_launches()
    img, port, _ = _pair("tied5_bac", backend)
    rng = np.random.default_rng(3)
    lens = np.asarray(LENGTHS, np.int32)
    lp = np.log(rng.dirichlet(np.ones(img.num_states),
                              size=(len(lens), T_SHORT))).astype(np.float32)
    batch = port.decode_batch(lp, lens)
    for fn in (port.decode_arrays_fn(), port.decode_fn()):
        segs, counts = fn(torch.from_numpy(lp), torch.from_numpy(lens))
        assert segs.device.type == "cpu"
        assert [r.segments for r in port._to_results(
            segs.numpy(), counts.numpy())] == [r.segments for r in batch]
    assert port.decode_one(lp[0]).segments == batch[0].segments
    assert not kernels.launches


def test_kernel_wrapper_refuses_cpu_tensors():
    _, port, _ = _pair("tied4_abc", "collapsed")
    packed = torch.zeros((1, 4, port._collapsed_fwd.L), dtype=torch.int32)
    end = torch.zeros((1, 4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        vbt.viterbi_backtrace(port._bt_collapsed, packed, end,
                              torch.full((1,), 4, dtype=torch.int32), 2048)
