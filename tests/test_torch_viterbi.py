"""The port's collapsed Viterbi against the JAX package.

On CPU tensors ``CollapsedViterbi.forward`` takes its plain version
(``collapsed_viterbi_reference``). Packed backpointers, expanded with
``packed_to_full``, and end scores must be BIT-equal, within each
utterance's length, to the JAX XLA scan path (``_forward_scan``) and to
the JAX collapsed Pallas kernel run in interpret mode; decoded segments
must equal the JAX ``ViterbiDecoder``'s on the same posteriors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnacousticmodeling_tpu.decoder.image import (
    HmmImage,
    _csr_from_biphone_out,
    make_synthetic_image,
)
from nnacousticmodeling_tpu.decoder.viterbi import (
    ViterbiDecoder as JaxDecoder,
)
from nnacousticmodeling_tpu_torch import kernels
from nnacousticmodeling_tpu_torch.decoder.viterbi import ViterbiDecoder
from nnacousticmodeling_tpu_torch.decoder.viterbi_collapsed import (
    CollapsedViterbi,
)


def _to_bac(img: HmmImage) -> HmmImage:
    """The same model with triphones enumerated center-major
    (idx = b*P^2 + a*P + c), the graph builder's 'bac' order."""
    P = img.num_phones
    b, a, c = np.meshgrid(np.arange(P), np.arange(P), np.arange(P),
                          indexing="ij")
    old = (a * P * P + b * P + c).reshape(-1)
    bi_out = img.biphone_out[old]
    offsets, values = _csr_from_biphone_out(bi_out, img.num_biphones)
    return HmmImage(
        num_phones=P, num_biphones=img.num_biphones,
        num_triphones=img.num_triphones, num_states=img.num_states,
        start_idxs=img.start_idxs, end_idxs=img.end_idxs,
        biphone_in=img.biphone_in[old], biphone_out=bi_out,
        state_idxs=img.state_idxs[old], tp_selfloop=img.tp_selfloop[old],
        tp_transition=img.tp_transition[old], out_offsets=offsets,
        out_values=values, lm=img.lm,
        phone_names=[img.phone_names[i] for i in old]).validate()


def _irregular_ends(img: HmmImage) -> HmmImage:
    """End biphone of phone p at (p, (p+1) mod P): no common end right
    context, so the collapsed kernel refuses the image and the JAX cube
    kernel takes its one-hot ``E_end`` path."""
    P = img.num_phones
    ends = np.array([p * P + (p + 1) % P for p in range(P)], np.int32)
    return dataclasses.replace(img, end_idxs=ends).validate()


def _posteriors(rng, utts, tmax, num_states):
    lens = rng.integers(6, tmax + 1, size=utts)
    lens[0] = tmax
    lp = np.log(rng.dirichlet(np.ones(num_states),
                              size=(utts, tmax))).astype(np.float32)
    return lp, lens


@pytest.mark.parametrize("order", ["abc", "bac"])
@pytest.mark.parametrize("beam", [None, 2.0])
@pytest.mark.parametrize("num_phones,utts,tmax", [(4, 3, 17), (9, 2, 10)])
def test_plain_forward_bit_equal_to_jax(num_phones, utts, tmax, beam, order):
    seed = num_phones + (0 if beam is None else 1)
    rng = np.random.default_rng(seed)
    img = make_synthetic_image(num_phones=num_phones,
                               num_states=3 * num_phones + 2, seed=seed,
                               pdf_tied_transitions=True)
    if order == "bac":
        img = _to_bac(img)
    lp, lens = _posteriors(rng, utts, tmax, img.num_states)
    kw = dict(pip=5.0, lmw=1.5, beam=beam)
    xla = JaxDecoder(img, backend="xla", **kw)
    col = JaxDecoder(img, backend="collapsed", **kw)
    port = ViterbiDecoder(img, device="cpu", **kw)
    ck = port._collapsed_fwd
    assert port._cube_order == order == col._cube_order
    assert (ck.Pp, ck.L) == (col._collapsed_fwd.Pp, col._collapsed_fwd.L)
    if num_phones == 9:
        assert ck.Pp == 32        # the mid-size regime (Pp % 128 != 0)
    np.testing.assert_array_equal(ck._bi2lane_np,
                                  col._collapsed_fwd._bi2lane_np)

    before = kernels.launches["collapsed_viterbi_forward"]
    packed, end = ck.forward(torch.from_numpy(lp), torch.from_numpy(lens))
    assert kernels.launches["collapsed_viterbi_forward"] == before
    assert packed.dtype == torch.int32 and end.dtype == torch.float32
    assert end.shape == (utts, tmax, num_phones)
    full = ck.packed_to_full(packed.numpy())
    end = end.numpy()

    want_xla = jax.vmap(xla._forward_scan)(jnp.asarray(lp))
    got_col = col._collapsed_fwd.forward(jnp.asarray(lp), jnp.asarray(lens))
    want_kernel = (col._collapsed_fwd.packed_to_full(np.asarray(got_col[0])),
                   np.asarray(got_col[1]))
    for want_packed, want_end in (want_xla, want_kernel):
        for u, l in enumerate(lens):
            np.testing.assert_array_equal(full[u, :l],
                                          np.asarray(want_packed)[u, :l])
            np.testing.assert_array_equal(end[u, :l],
                                          np.asarray(want_end)[u, :l])

    want_segs = [r.segments for r in xla.decode_batch(lp, lens)]
    assert [r.segments for r in port.decode_batch(lp, lens)] == want_segs
    assert port.decode_one(lp[1, :lens[1]]).segments == want_segs[1]


def test_long_utterance_grows_pack():
    """T > 2046 frames decode through a per-pack instance; the backtrace
    reads the pack of the instance that produced the rows."""
    rng = np.random.default_rng(5)
    img = make_synthetic_image(num_phones=3, num_states=11, seed=5,
                               pdf_tied_transitions=True)
    t = 2050
    lp = np.log(rng.dirichlet(np.ones(img.num_states), size=t)
                ).astype(np.float32)
    port = ViterbiDecoder(img, pip=4.0, device="cpu")
    ck = port._collapsed_for_t(t)
    assert ck.pack == 4096 and ck is not port._collapsed_fwd
    got = port.decode_one(lp).segments
    assert got[0][0] == 0 and got[-1][1] == t
    assert all(b < e for b, e, _ in got)
    assert all(got[i][1] == got[i + 1][0] for i in range(len(got) - 1))


@pytest.mark.parametrize("case,backend,expected", [
    ("untied", "auto", "xla"),         # untied transitions: twin
    ("tied", "xla", "xla"),
    ("tied", "pallas", "pallas"),      # the dense-cube kernel
    ("partial", "auto", "xla"),        # not a cube: general twin
])
def test_former_unported_paths_decode_to_jax_segments(case, backend,
                                                      expected):
    img = {"untied": lambda: make_synthetic_image(num_phones=4, seed=0),
           "tied": lambda: make_synthetic_image(
               num_phones=4, seed=0, pdf_tied_transitions=True),
           "partial": lambda: make_synthetic_image(
               num_phones=3, seed=2, full_context=False)}[case]()
    rng = np.random.default_rng(3)
    lp, lens = _posteriors(rng, 3, 12, img.num_states)
    port = ViterbiDecoder(img, pip=5.0, backend=backend, device="cpu")
    assert port.backend == expected
    want = JaxDecoder(img, pip=5.0, backend="xla").decode_batch(lp, lens)
    assert [r.segments for r in port.decode_batch(lp, lens)] == \
        [r.segments for r in want]


def test_collapsed_viterbi_runs_on_the_card_unless_asked(monkeypatch):
    """With no device ``CollapsedViterbi`` takes the card, as
    ``CubeViterbi`` and ``ViterbiDecoder`` do: without one it raises, and
    with ``device="cpu"`` it decodes to the decoder's rows."""
    img = make_synthetic_image(num_phones=4, num_states=14, seed=6,
                               pdf_tied_transitions=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CollapsedViterbi(img, "abc", pip=-5.0, lmw=1.5)
    cv = CollapsedViterbi(img, "abc", pip=-5.0, lmw=1.5, device="cpu")
    assert cv.device == torch.device("cpu")
    rng = np.random.default_rng(4)
    lp, lens = _posteriors(rng, 3, 11, img.num_states)
    lp_t, lens_t = torch.from_numpy(lp), torch.from_numpy(lens)
    packed, end = cv.forward(lp_t, lens_t)
    port = ViterbiDecoder(img, pip=5.0, lmw=1.5, device="cpu")
    want_packed, want_end = port._collapsed_fwd.forward(lp_t, lens_t)
    assert torch.equal(packed, want_packed) and torch.equal(end, want_end)
    want = JaxDecoder(img, pip=5.0, lmw=1.5, backend="xla").decode_batch(
        lp, lens)
    segs, counts = port._collapsed_backtrace(packed, end, lens_t)
    assert [r.segments for r in port._to_results(
        segs.numpy(), counts.numpy())] == [r.segments for r in want]


@pytest.mark.parametrize("order", ["abc", "bac"])
@pytest.mark.parametrize("beam", [None, 2.0])
def test_collapsed_plain_forward_follows_jax_on_nan_frames(beam, order):
    """An all-NaN frame through the collapsed plain version and the JAX
    kernel in interpret mode: no row matches the NaN max, both keep the
    key INT_MAX, and every packed entry and end score agrees."""
    rng = np.random.default_rng(3)
    img = make_synthetic_image(num_phones=4, seed=4,
                               pdf_tied_transitions=True)
    if order == "bac":
        img = _to_bac(img)
    lp = np.log(rng.dirichlet(np.ones(img.num_states), size=(2, 9))
                ).astype(np.float32)
    lp[0, 4, :] = np.nan
    lens = np.array([9, 9], np.int32)
    kw = dict(pip=5.0, lmw=1.5, beam=beam)
    col = JaxDecoder(img, backend="collapsed", **kw)._collapsed_fwd
    ck = ViterbiDecoder(img, device="cpu", **kw)._collapsed_fwd
    packed, end = ck.forward(torch.from_numpy(lp), torch.from_numpy(lens))
    want_packed, want_end = (np.asarray(a) for a in col.forward(
        jnp.asarray(lp), jnp.asarray(lens)))
    np.testing.assert_array_equal(packed.numpy(), want_packed)
    assert np.array_equal(end.numpy(), want_end, equal_nan=True)
    assert (packed.numpy()[0, 4] == np.iinfo(np.int32).max).all()
