"""The port's dense-cube Viterbi against the JAX package.

On CPU tensors ``CubeViterbi.forward`` takes its plain version
(``cube_viterbi_reference``). Packed backpointers and end scores must be
BIT-equal, within each utterance's length, to the JAX cube Pallas kernel
run in interpret mode (same right-major lane axis) and, after
``lane_map``, to the JAX XLA scan path; decoded segments through
``backend="pallas"`` must equal the JAX decoder's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnacousticmodeling_tpu.decoder.image import make_synthetic_image
from nnacousticmodeling_tpu.decoder.viterbi import (
    ViterbiDecoder as JaxDecoder,
)
from nnacousticmodeling_tpu.decoder.viterbi_pallas import PallasCubeViterbi
from nnacousticmodeling_tpu_torch import kernels
from nnacousticmodeling_tpu_torch.decoder import UnsupportedImage
from nnacousticmodeling_tpu_torch.decoder.viterbi import ViterbiDecoder
from nnacousticmodeling_tpu_torch.decoder.viterbi_cube import CubeViterbi

from test_torch_viterbi import _irregular_ends, _posteriors, _to_bac


@pytest.mark.parametrize("ends", ["regular", "irregular"])
@pytest.mark.parametrize("order", ["abc", "bac"])
@pytest.mark.parametrize("beam", [None, 2.0])
@pytest.mark.parametrize("num_phones,utts,tmax", [(4, 3, 13), (9, 2, 9)])
def test_plain_forward_bit_equal_to_jax(num_phones, utts, tmax, beam, order,
                                        ends):
    seed = num_phones + (0 if beam is None else 1)
    rng = np.random.default_rng(seed)
    img = make_synthetic_image(num_phones=num_phones,
                               num_states=3 * num_phones + 2, seed=seed,
                               pdf_tied_transitions=True)
    if order == "bac":
        img = _to_bac(img)
    if ends == "irregular":
        img = _irregular_ends(img)
    lp, lens = _posteriors(rng, utts, tmax, img.num_states)
    jk = PallasCubeViterbi(img, order, pip=-5.0, lmw=1.5, beam=beam,
                           interpret=True)
    assert (jk._E_end is None) == (ends == "regular")
    cv = CubeViterbi(img, order, pip=-5.0, lmw=1.5, beam=beam, device="cpu")
    assert (cv.P, cv.B, cv.S, cv.PS) == (jk.P, jk.B, jk.S, jk.PS)
    np.testing.assert_array_equal(cv.lane_map, jk.lane_map)
    np.testing.assert_array_equal(cv.end_lane.numpy(), jk.end_lane)
    np.testing.assert_array_equal(cv.bi_in_lane.numpy(), jk.bi_in_lane)

    before = dict(kernels.launches)
    packed, end = cv.forward(torch.from_numpy(lp), torch.from_numpy(lens))
    assert dict(kernels.launches) == before
    assert packed.dtype == torch.int32 and end.dtype == torch.float32
    assert packed.shape == (utts, tmax, num_phones ** 2)
    assert end.shape == (utts, tmax, num_phones)
    packed, end = packed.numpy(), end.numpy()

    want_packed, want_end = (np.asarray(a) for a in jk.forward(
        jnp.asarray(lp), jnp.asarray(lens)))
    xla = JaxDecoder(img, pip=5.0, lmw=1.5, backend="xla", beam=beam)
    x_packed, x_end = (np.asarray(a) for a in jax.vmap(xla._forward_scan)(
        jnp.asarray(lp)))
    for u, l in enumerate(lens):
        np.testing.assert_array_equal(packed[u, :l], want_packed[u, :l])
        np.testing.assert_array_equal(end[u, :l], want_end[u, :l])
        np.testing.assert_array_equal(packed[u, :l][..., cv.lane_map],
                                      x_packed[u, :l])
        np.testing.assert_array_equal(end[u, :l], x_end[u, :l])

    port = ViterbiDecoder(img, pip=5.0, lmw=1.5, beam=beam, backend="pallas",
                          device="cpu")
    assert port.backend == "pallas" and port._collapsed_fwd is None
    want = [r.segments for r in xla.decode_batch(lp, lens)]
    assert [r.segments for r in port.decode_batch(lp, lens)] == want


def test_refusals_match_jax():
    """The semantic refusals stay (UnsupportedImage, shared with the
    collapsed kernel); the TPU's lane-tiling refusal does not."""
    tied = make_synthetic_image(num_phones=4, seed=0,
                                pdf_tied_transitions=True)
    assert tied.num_biphones % 128 != 0
    CubeViterbi(tied, "abc", pip=-5.0, lmw=1.0, device="cpu")
    untied = make_synthetic_image(num_phones=4, seed=0)
    with pytest.raises(UnsupportedImage, match="tied"):
        CubeViterbi(untied, "abc", pip=-5.0, lmw=1.0, device="cpu")
    with pytest.raises(Exception, match="tied"):
        PallasCubeViterbi(untied, "abc", pip=-5.0, lmw=1.0, interpret=True)
    partial = make_synthetic_image(num_phones=3, seed=2, full_context=False)
    with pytest.raises(UnsupportedImage, match="cube"):
        CubeViterbi(partial, "abc", pip=-5.0, lmw=1.0, device="cpu")
    with pytest.raises(UnsupportedImage):
        ViterbiDecoder(untied, backend="pallas", device="cpu")


def test_kernel_wrapper_refuses_cpu_tensors():
    from nnacousticmodeling_tpu_torch.decoder.viterbi_cube import (
        cube_viterbi_forward)
    img = make_synthetic_image(num_phones=3, seed=0,
                               pdf_tied_transitions=True)
    cv = CubeViterbi(img, "abc", pip=-5.0, lmw=1.0, device="cpu")
    lp = torch.zeros((1, 4, img.num_states))
    with pytest.raises(ValueError, match="CUDA"):
        cube_viterbi_forward(cv, lp, torch.full((1,), 4, dtype=torch.int32))


@pytest.mark.parametrize("backend", ["pallas", "auto"])
def test_backtrace_ignores_unwritten_rows(backend):
    """The kernels leave rows at or past an utterance's length unwritten;
    the backtrace of a zero-length utterance must not read through them
    (on the card an out-of-range index from such a row is a device-side
    assert that ends the process's CUDA context)."""
    rng = np.random.default_rng(5)
    img = make_synthetic_image(num_phones=4, num_states=14, seed=4,
                               pdf_tied_transitions=True)
    dec = ViterbiDecoder(img, pip=5.0, lmw=1.5, backend=backend,
                         device="cpu")
    lp, _ = _posteriors(rng, 3, 9, img.num_states)
    lens = torch.tensor([9, 0, 4], dtype=torch.int32)
    lp_t = torch.from_numpy(lp)
    fwd = dec._pallas_fwd if backend == "pallas" else dec._collapsed_fwd
    packed, end = fwd.forward(lp_t, lens)
    walk = (dec._pallas_backtrace if backend == "pallas"
            else dec._collapsed_backtrace)
    segs, counts = walk(packed, end, lens)
    garbage = packed.clone()
    garbage[1] = 2 ** 30 + 12345            # what an unwritten row may hold
    garbage[2, 4:] = -(2 ** 30)
    segs_g, counts_g = walk(garbage, end, lens)
    assert counts_g.tolist() == counts.tolist() and counts[1] == 0
    for u in (0, 2):
        assert torch.equal(segs_g[u, :counts[u]], segs[u, :counts[u]])


@pytest.mark.parametrize("order", ["abc", "bac"])
@pytest.mark.parametrize("beam", [None, 2.0])
def test_plain_forward_follows_jax_on_nan_frames(beam, order):
    """An all-NaN frame: the TPU kernel's first max matches no row (arg =
    P, bt = the sum of tt2 over rows equal to P); the plain version gives
    its bits (it raised an out-of-range gather before)."""
    rng = np.random.default_rng(3)
    img = make_synthetic_image(num_phones=4, seed=4,
                               pdf_tied_transitions=True)
    if order == "bac":
        img = _to_bac(img)
    lp = np.log(rng.dirichlet(np.ones(img.num_states), size=(2, 9))
                ).astype(np.float32)
    lp[0, 4, :] = np.nan
    lens = np.array([9, 9], np.int32)
    jk = PallasCubeViterbi(img, order, pip=-5.0, lmw=1.5, beam=beam,
                           interpret=True)
    cv = CubeViterbi(img, order, pip=-5.0, lmw=1.5, beam=beam, device="cpu")
    assert cv.PS > cv.P                 # pad row P holds the exported bt
    packed, end = cv.forward(torch.from_numpy(lp), torch.from_numpy(lens))
    want_packed, want_end = (np.asarray(a) for a in jk.forward(
        jnp.asarray(lp), jnp.asarray(lens)))
    np.testing.assert_array_equal(packed.numpy(), want_packed)
    assert np.array_equal(end.numpy(), want_end, equal_nan=True)
