"""The port's device decode API against the JAX package.

``ViterbiDecoder.decode_arrays_fn()`` and ``decode_fn()`` return
callables ``(lp (U, T, S), lengths (U,)) -> (segs, counts)`` on device
tensors. Their ``segs`` (within each utterance's count) and ``counts``
must be BIT-equal to ``jax.jit`` of the JAX decoder's functions of the
same names (``viterbi.py:590-603``, ``:622-625``) on the same numpy
posteriors, for every backend (the JAX kernels in interpret mode), cube
order, beam and ragged lengths down to 0, 1 and 2 frames. The callables
make no synchronising call (checked here by intercepting the operations
that would be one on the card), share ``decode_batch``'s route, and the
backtrace's fixed-hop walk equals its early-exit walk.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from nnacousticmodeling_tpu.decoder.image import make_synthetic_image
from nnacousticmodeling_tpu.decoder.viterbi import (
    ViterbiDecoder as JaxDecoder,
)
from nnacousticmodeling_tpu_torch.decoder.viterbi import (
    TIME_PACK,
    ViterbiDecoder,
)

from test_torch_viterbi import _to_bac

IMAGES = {
    "tied4_abc": lambda: make_synthetic_image(
        num_phones=4, num_states=14, seed=6, pdf_tied_transitions=True),
    "tied5_bac": lambda: _to_bac(make_synthetic_image(
        num_phones=5, num_states=17, seed=7, pdf_tied_transitions=True)),
    "tied6_abc": lambda: make_synthetic_image(
        num_phones=6, num_states=20, seed=8, pdf_tied_transitions=True),
    # transitions per triphone: both kernels refuse it, the scan twin runs
    "untied": lambda: make_synthetic_image(num_phones=4, seed=0),
}
KW = dict(pip=5.0, lmw=1.5)
T_SHORT = 13
#: ragged lengths: the padded T, an empty utterance, the 1- and 2-frame
#: degenerate cases, and two in between
LENGTHS = (T_SHORT, 0, 1, 2, 7, 11)


def _posteriors(seed, utts, t, num_states):
    rng = np.random.default_rng(seed)
    return np.log(rng.dirichlet(np.ones(num_states),
                                size=(utts, t))).astype(np.float32)


def _assert_same(got, want):
    """(segs, counts) bit-equal within each utterance's count."""
    segs, counts = (np.asarray(a) for a in got)
    want_segs, want_counts = (np.asarray(a) for a in want)
    assert segs.dtype == np.int32 and segs.shape == want_segs.shape
    np.testing.assert_array_equal(counts, want_counts)
    for u, k in enumerate(want_counts):
        np.testing.assert_array_equal(segs[u, :k], want_segs[u, :k])


def _pair(name, backend, beam):
    img = IMAGES[name]()
    port = ViterbiDecoder(img, backend=backend, beam=beam, device="cpu",
                          **KW)
    ref = JaxDecoder(img, backend=backend, beam=beam, **KW)
    return img, port, ref


@pytest.mark.parametrize("beam", [None, 3.0])
@pytest.mark.parametrize("name,backend", [
    ("tied4_abc", "collapsed"), ("tied5_bac", "collapsed"),
    ("tied4_abc", "pallas"), ("tied5_bac", "pallas"),
    ("tied4_abc", "xla"), ("tied5_bac", "xla"), ("untied", "auto"),
])
def test_decode_arrays_fn_bit_equal_to_jax(name, backend, beam):
    img, port, ref = _pair(name, backend, beam)
    assert port.backend == (ref.backend if backend != "auto" else "xla")
    lens = np.asarray(LENGTHS, np.int32)
    lp = _posteriors(len(name) + (beam is not None), len(lens), T_SHORT,
                     img.num_states)
    want = jax.jit(ref.decode_arrays_fn())(lp, lens)
    got = port.decode_arrays_fn()(torch.from_numpy(lp),
                                  torch.from_numpy(lens))
    _assert_same(got, want)
    assert np.asarray(want[1])[1] == 0 and got[1][1] == 0


@pytest.mark.parametrize("beam", [None, 3.0])
@pytest.mark.parametrize("name", ["tied4_abc", "tied5_bac", "untied"])
def test_decode_fn_bit_equal_to_jax(name, beam):
    """``decode_fn`` is the scan twin whatever the decoder's backend."""
    img, port, ref = _pair(name, "auto", beam)
    lens = np.asarray(LENGTHS, np.int32)
    lp = _posteriors(len(name) + 2 * (beam is not None), len(lens), T_SHORT,
                     img.num_states)
    want = jax.jit(ref.decode_fn())(lp, lens)
    got = port.decode_fn()(torch.from_numpy(lp), torch.from_numpy(lens))
    _assert_same(got, want)


@pytest.mark.parametrize("fn", ["decode_arrays_fn", "decode_fn"])
def test_cube_at_time_pack_takes_the_scan_twin(monkeypatch, fn):
    """At T = TIME_PACK - 1 the cube kernel's fixed pack factor is too
    small: both packages take the scan twin (with a grown pack)."""
    img, port, ref = _pair("tied4_abc", "pallas", None)
    t = TIME_PACK - 1
    lens = np.asarray([t, 2, 1500], np.int32)
    lp = _posteriors(11, len(lens), t, img.num_states)

    def refuse(*_):
        raise AssertionError("the cube kernel's forward ran at T >= "
                             "TIME_PACK - 1")

    monkeypatch.setattr(port._pallas_fwd, "forward", refuse)
    want = jax.jit(getattr(ref, fn)())(lp, lens)
    got = getattr(port, fn)()(torch.from_numpy(lp), torch.from_numpy(lens))
    _assert_same(got, want)


def test_host_lengths_give_the_device_lengths_results():
    """A host sequence of lengths (copied once by the call) gives the
    device tensor's results."""
    img, port, ref = _pair("tied6_abc", "collapsed", None)
    lens = [T_SHORT, 4, 0]
    lp = torch.from_numpy(_posteriors(3, 3, T_SHORT, img.num_states))
    fn = port.decode_arrays_fn()
    _assert_same(fn(lp, lens), fn(lp, torch.tensor(lens)))
    _assert_same(fn(lp, np.asarray(lens, np.int64)),
                 jax.jit(ref.decode_arrays_fn())(lp.numpy(),
                                                 np.asarray(lens)))


@pytest.mark.parametrize("fn", ["decode_arrays_fn", "decode_fn"])
@pytest.mark.parametrize("case", [
    "lp_meta", "lp_numpy", "lp_states", "lp_2d", "lp_int", "lens_meta",
    "lens_long", "lens_2d", "lens_float", "lens_host_long",
    "lens_host_range",
])
def test_bad_inputs_raise(fn, case):
    """No silent move: a tensor on another device, or lengths of the
    wrong shape or type, raise ``ValueError``."""
    img = IMAGES["tied4_abc"]()
    port = ViterbiDecoder(img, device="cpu", **KW)
    s = img.num_states
    lp = torch.from_numpy(_posteriors(1, 3, 6, s))
    lens = torch.tensor([6, 3, 0], dtype=torch.int32)
    args = {
        "lp_meta": (lp.to("meta"), lens),
        "lp_numpy": (lp.numpy(), lens),
        "lp_states": (lp[..., :-1], lens),
        "lp_2d": (lp[0], lens),
        "lp_int": (lp.to(torch.int32), lens),
        "lens_meta": (lp, lens.to("meta")),
        "lens_long": (lp, torch.tensor([6, 3, 0, 1], dtype=torch.int32)),
        "lens_2d": (lp, lens[:, None]),
        "lens_float": (lp, lens.float()),
        "lens_host_long": (lp, [6, 3]),
        "lens_host_range": (lp, [7, 3, 0]),
    }[case]
    with pytest.raises(ValueError):
        getattr(port, fn)()(*args)


def test_frame_ceiling_raises():
    """The frame ceiling of ``decode_batch`` holds for the callables."""
    img = make_synthetic_image(num_phones=12, num_states=38, seed=2,
                               pdf_tied_transitions=True)
    port = ViterbiDecoder(img, backend="pallas", device="cpu", **KW)
    lp = torch.zeros((1, 1, img.num_states)).expand(
        1, port.max_frames + 1, -1)          # a view: nothing allocated
    for fn in (port.decode_arrays_fn(), port.decode_fn()):
        with pytest.raises(ValueError, match="ceiling"):
            fn(lp, torch.tensor([1]))


# ---- no synchronising call ---------------------------------------------
class _SyncError(AssertionError):
    pass


#: operations that wait for the card or copy between host and device
#: there: reading a value to the host (``item``, ``bool``, ``int``), a
#: data-dependent shape, and a tensor made from host data (a pageable
#: host-to-device copy on the card)
_SYNC_OPS = {"aten::_local_scalar_dense", "aten::nonzero",
             "aten::lift_fresh", "aten::masked_select"}
_HOST_METHODS = {torch.Tensor.cpu, torch.Tensor.numpy, torch.Tensor.tolist,
                 torch.Tensor.item, torch.Tensor.__bool__,
                 torch.Tensor.__int__, torch.Tensor.__float__}


class _NoSyncDispatch(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name in _SYNC_OPS:
            raise _SyncError(f"synchronising operation {func}")
        return func(*args, **(kwargs or {}))


class _NoHostMethods(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _HOST_METHODS:
            raise _SyncError(f"host read {func.__name__}")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _no_sync():
    with _NoHostMethods(), _NoSyncDispatch():
        yield


@pytest.mark.parametrize("fn", ["decode_arrays_fn", "decode_fn"])
@pytest.mark.parametrize("name,backend,beam", [
    ("tied4_abc", "collapsed", None), ("tied5_bac", "collapsed", 3.0),
    ("tied4_abc", "pallas", 3.0), ("tied5_bac", "xla", None),
    ("untied", "auto", 3.0),
])
def test_callables_make_no_synchronising_call(name, backend, beam, fn):
    img = IMAGES[name]()
    port = ViterbiDecoder(img, backend=backend, beam=beam, device="cpu",
                          **KW)
    lp = torch.from_numpy(_posteriors(4, len(LENGTHS), T_SHORT,
                                      img.num_states))
    lens = torch.tensor(LENGTHS, dtype=torch.int32)
    call = getattr(port, fn)()
    want = call(lp, lens)
    with _no_sync():
        got = call(lp, lens)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_no_sync_check_sees_the_early_exit_walk():
    """The interception above does catch a synchronising call: the
    early-exit walk of ``decode_batch`` reads a flag to the host."""
    img = IMAGES["tied4_abc"]()
    port = ViterbiDecoder(img, device="cpu", **KW)
    lp = torch.from_numpy(_posteriors(5, len(LENGTHS), T_SHORT,
                                      img.num_states))
    lens = torch.tensor(LENGTHS, dtype=torch.int32)
    with pytest.raises(_SyncError):
        with _no_sync():
            port._decode_arrays(lp, lens)
    with pytest.raises(_SyncError, match="lift_fresh"):
        with _no_sync():
            port.decode_arrays_fn()(lp, list(LENGTHS))


# ---- one route ----------------------------------------------------------
@pytest.mark.parametrize("name,backend,beam", [
    ("tied4_abc", "collapsed", None), ("tied5_bac", "collapsed", 3.0),
    ("tied4_abc", "pallas", None), ("tied5_bac", "pallas", 3.0),
    ("tied4_abc", "xla", 3.0), ("untied", "auto", None),
])
def test_decode_batch_and_decode_arrays_fn_share_one_route(
        monkeypatch, name, backend, beam):
    """Both go through ``_decode_arrays``, once a call, and give the same
    segments; ``decode_one`` too."""
    img = IMAGES[name]()
    port = ViterbiDecoder(img, backend=backend, beam=beam, device="cpu",
                          **KW)
    lp = _posteriors(6, len(LENGTHS), T_SHORT, img.num_states)
    calls = []
    route = port._decode_arrays

    def counted(*args, **kwargs):
        calls.append(kwargs.get("early_exit", True))
        return route(*args, **kwargs)

    monkeypatch.setattr(port, "_decode_arrays", counted)
    batch = port.decode_batch(lp, list(LENGTHS))
    segs, counts = port.decode_arrays_fn()(torch.from_numpy(lp),
                                           torch.tensor(LENGTHS))
    one = port.decode_one(lp[4, :LENGTHS[4]])
    assert calls == [True, False, True]
    assert [r.segments for r in port._to_results(
        segs.numpy(), counts.numpy())] == [r.segments for r in batch]
    assert one.segments == batch[4].segments


@pytest.mark.parametrize("backend", ["collapsed", "pallas", "xla"])
def test_fixed_hop_walk_equals_early_exit_walk(backend):
    """The walk without the host check runs all T hops; the hops after
    every utterance finished change nothing, also where the kernels leave
    rows unwritten (at or past an utterance's length)."""
    img = IMAGES["tied5_bac"]()
    port = ViterbiDecoder(img, backend=backend, device="cpu", **KW)
    lp = torch.from_numpy(_posteriors(7, len(LENGTHS), 40, img.num_states))
    lens = torch.tensor([40, 0, 1, 2, 9, 33], dtype=torch.int32)
    if backend == "collapsed":
        packed, end = port._collapsed_fwd.forward(lp, lens)
        walk = port._collapsed_backtrace
    elif backend == "pallas":
        packed, end = port._pallas_fwd.forward(lp, lens)
        walk = port._pallas_backtrace
    else:
        packed, end = port._forward_scan(lp)
        walk = port._device_backtrace
    early = walk(packed, end, lens)
    fixed = walk(packed, end, lens, early_exit=False)
    assert torch.equal(early[0], fixed[0]) and torch.equal(early[1],
                                                           fixed[1])
    garbage = packed.clone()
    garbage[1] = 2 ** 30 + 12345            # what an unwritten row may hold
    for u in (2, 4, 5):
        garbage[u, int(lens[u]):] = -(2 ** 30)
    fixed_g = walk(garbage, end, lens, early_exit=False)
    assert torch.equal(fixed_g[1], early[1]) and int(early[1][1]) == 0
    for u, k in enumerate(early[1].tolist()):
        assert torch.equal(fixed_g[0][u, :k], early[0][u, :k])
