"""The port's scan twins, backtrace and backend order against the JAX
package.

``_forward_scan_cube`` (dense cubes) and the general ``_forward_scan``
(any image, with the ``dense_fanin`` first-max export) are batched over
utterances in the port; their packed rows and end scores must be
BIT-equal to ``jax.vmap`` of the JAX twins for every frame. Decoded
segments must equal the JAX decoder's for every backend, and the
backend chosen must follow the JAX decoder's rule on a TPU (the one
deliberate difference: the port applies that rule on the CPU too).
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
from nnacousticmodeling_tpu.decoder.viterbi_pallas import (
    UnsupportedImage as JaxUnsupported,
)
from nnacousticmodeling_tpu_torch.decoder import UnsupportedImage
from nnacousticmodeling_tpu_torch.decoder.viterbi import ViterbiDecoder

from test_torch_viterbi import _irregular_ends, _posteriors, _to_bac

IMAGES = {
    # tied pdfs, transitions per triphone: both kernels refuse it
    "untied": lambda: make_synthetic_image(num_phones=4, seed=0),
    # context-independent pdfs, transitions per triphone (synth_data's)
    "ci": lambda: make_synthetic_image(num_phones=4, seed=1, tied=False),
    "untied_bac": lambda: _to_bac(make_synthetic_image(num_phones=3, seed=3)),
    # not a dense cube: the general scan twin
    "partial": lambda: make_synthetic_image(num_phones=3, seed=2,
                                            full_context=False),
    "tied": lambda: make_synthetic_image(num_phones=4, seed=4,
                                         pdf_tied_transitions=True),
    "tied_irregular": lambda: _irregular_ends(make_synthetic_image(
        num_phones=4, seed=5, pdf_tied_transitions=True)),
}


def _jax_rule(img, requested="auto"):
    """The backend the JAX decoder picks on a TPU (its off-TPU "auto" is
    always "xla"): the collapsed kernel, then the cube kernel, then the
    scan path, each kernel tried through its constructor."""
    if requested == "xla":
        return "xla"
    order = JaxDecoder(img, backend="xla")._cube_order
    if order is None:
        return "xla"
    from nnacousticmodeling_tpu.decoder.viterbi_collapsed import (
        PallasCollapsedViterbi)
    from nnacousticmodeling_tpu.decoder.viterbi_pallas import (
        PallasCubeViterbi)
    kernels = {"collapsed": PallasCollapsedViterbi,
               "pallas": PallasCubeViterbi}
    tries = ["collapsed", "pallas"] if requested == "auto" else [requested]
    for name in tries:
        try:
            kernels[name](img, order, pip=-5.0, lmw=1.0, interpret=True)
            return name
        except JaxUnsupported:
            if requested != "auto":
                return "raises"
    return "xla"


@pytest.mark.parametrize("beam", [None, 2.0])
@pytest.mark.parametrize("name", ["untied", "ci", "untied_bac", "partial"])
def test_scan_twins_bit_equal_to_jax(name, beam):
    img = IMAGES[name]()
    rng = np.random.default_rng(len(name))
    lp, lens = _posteriors(rng, 3, 14, img.num_states)
    kw = dict(pip=5.0, lmw=1.5, beam=beam)
    jax_dec = JaxDecoder(img, backend="xla", **kw)
    port = ViterbiDecoder(img, device="cpu", **kw)
    assert port.backend == "xla"
    assert port._cube_order == jax_dec._cube_order
    assert (port._cube_order is None) == (name == "partial")
    packed, end = port._forward_scan(torch.from_numpy(lp))
    want_packed, want_end = jax.vmap(jax_dec._forward_scan)(jnp.asarray(lp))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want_packed))
    np.testing.assert_array_equal(end.numpy(), np.asarray(want_end))
    want = [r.segments for r in jax_dec.decode_batch(lp, lens)]
    assert [r.segments for r in port.decode_batch(lp, lens)] == want
    assert port.decode_one(lp[1, :lens[1]]).segments == want[1]


@pytest.mark.parametrize("beam", [None, 2.0])
@pytest.mark.parametrize("name", ["untied", "ci", "untied_bac", "tied"])
def test_cube_twin_bit_equal_to_general_twin(monkeypatch, name, beam):
    """On a dense cube the general twin's ``dense_fanin`` export (CSR
    order = ascending left context) gives the cube twin's bits."""
    img = IMAGES[name]()
    rng = np.random.default_rng(11 + len(name))
    lp, _ = _posteriors(rng, 3, 14, img.num_states)
    port = ViterbiDecoder(img, pip=5.0, lmw=1.5, beam=beam, backend="xla",
                          device="cpu")
    assert port._cube_order is not None
    cube = port._forward_scan(torch.from_numpy(lp))
    monkeypatch.setattr(port, "_cube_order", None)
    general = port._forward_scan(torch.from_numpy(lp))
    for got, want in zip(general, cube):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("backend", ["auto", "collapsed", "pallas", "xla"])
@pytest.mark.parametrize("name", sorted(IMAGES))
def test_backend_rule_and_segments(name, backend):
    img = IMAGES[name]()
    expected = _jax_rule(img, backend)
    kw = dict(pip=5.0, lmw=1.0, beam=None)
    if expected == "raises":
        with pytest.raises(UnsupportedImage):
            ViterbiDecoder(img, backend=backend, device="cpu", **kw)
        return
    port = ViterbiDecoder(img, backend=backend, device="cpu", **kw)
    assert port.backend == expected
    rng = np.random.default_rng(7)
    lp, lens = _posteriors(rng, 3, 12, img.num_states)
    want = JaxDecoder(img, backend="xla", **kw).decode_batch(lp, lens)
    assert [r.segments for r in port.decode_batch(lp, lens)] == \
        [r.segments for r in want]


@pytest.mark.parametrize("env,name,expected", [
    ("xla", "tied", "xla"), ("pallas", "tied", "pallas"),
    ("collapsed", "tied", "collapsed"), ("pallas", "untied", "raises"),
    ("collapsed", "tied_irregular", "raises"), ("auto", "tied", "collapsed"),
])
def test_env_overrides_auto(monkeypatch, env, name, expected):
    img = IMAGES[name]()
    assert _jax_rule(img, env) == expected
    monkeypatch.setenv("NNAM_VITERBI_BACKEND", env)
    if expected == "raises":
        with pytest.raises(UnsupportedImage):
            ViterbiDecoder(img, device="cpu")
        return
    assert ViterbiDecoder(img, device="cpu").backend == expected
    # an explicit backend is not overridden
    assert ViterbiDecoder(img, backend="xla", device="cpu").backend == "xla"


def test_long_utterance_on_cube_backend_takes_the_twin(monkeypatch):
    """T >= 2047 frames exceed the cube kernel's fixed pack: the decode
    goes through the scan twin, as the JAX decoder's does, and its
    segments equal the JAX decoder's."""
    rng = np.random.default_rng(9)
    img = make_synthetic_image(num_phones=3, num_states=11, seed=9,
                               pdf_tied_transitions=True)
    t = 2100
    lp = np.log(rng.dirichlet(np.ones(img.num_states), size=t)
                ).astype(np.float32)
    port = ViterbiDecoder(img, pip=4.0, backend="pallas", device="cpu")
    assert port.backend == "pallas"

    def refuse(*a, **k):
        raise AssertionError("the cube kernel ran on a long utterance")

    monkeypatch.setattr(port._pallas_fwd, "forward", refuse)
    got = port.decode_one(lp).segments
    want = JaxDecoder(img, pip=4.0, backend="pallas").decode_one(lp).segments
    assert got == want
    assert got[0][0] == 0 and got[-1][1] == t


def test_frame_ceiling_error():
    img = make_synthetic_image(num_phones=4, num_states=12, seed=0)
    port = ViterbiDecoder(img, device="cpu")
    assert port.max_frames == JaxDecoder(img).max_frames
    with pytest.raises(ValueError, match="ceiling"):
        port._time_pack_for(port.max_frames + 10)
    with pytest.raises(ValueError, match="ceiling"):
        port._validate_frames(port.max_frames + 10)


def _nan_frame(img, seed=0):
    """U=2, T=9 Dirichlet log-posteriors whose utterance 0 has an all-NaN
    frame 4, as a diverged acoustic model gives."""
    rng = np.random.default_rng(seed)
    lp = np.log(rng.dirichlet(np.ones(img.num_states), size=(2, 9))
                ).astype(np.float32)
    lp[0, 4, :] = np.nan
    return lp


@pytest.mark.parametrize("beam", [None, 2.0])
@pytest.mark.parametrize("name", ["untied", "ci", "untied_bac", "partial"])
def test_scan_twins_follow_jax_on_nan_frames(name, beam):
    """The JAX twins' first max (``jnp.argmax`` / ``jnp.max``) takes a
    row's first NaN: both port twins give their bits (they raised an
    out-of-range gather before) and the JAX decoder's segments."""
    img = IMAGES[name]()
    lp = _nan_frame(img)
    kw = dict(pip=5.0, lmw=1.5, beam=beam)
    jax_dec = JaxDecoder(img, backend="xla", **kw)
    port = ViterbiDecoder(img, backend="xla", device="cpu", **kw)
    want_packed, want_end = (np.asarray(a) for a in jax.vmap(
        jax_dec._forward_scan)(jnp.asarray(lp)))
    lp_t = torch.from_numpy(lp)
    twins = [port._forward_scan_general(lp_t)]
    if port._cube_order is not None:
        twins.append(port._forward_scan_cube(lp_t, port._cube_order))
    assert len(twins) == (1 if name == "partial" else 2)
    for packed, end in twins:
        np.testing.assert_array_equal(packed.numpy(), want_packed)
        assert np.array_equal(end.numpy(), want_end, equal_nan=True)
    assert np.isnan(want_end[0, 4]).all() == (beam is None)
    lens = np.array([9, 7])
    want = [r.segments for r in jax_dec.decode_batch(lp, lens)]
    assert [r.segments for r in port.decode_batch(lp, lens)] == want
