"""The port's raw-audio features against the JAX package.

The numpy tables (window, mel banks in both conventions, DFT bases, DCT)
and ``cmn_per_speaker`` are copies and must be equal; framing must be
bit-equal. On CPU tensors ``fbank_cuda`` takes the plain ``fbank``,
which must be within 1e-3 in the log domain (the tolerance of the JAX
package's own kernel test, ``tests/test_features.py:84``) of JAX
``fbank_pallas`` in interpret mode and of JAX ``fbank``, for both mel
conventions: the products run in another library and summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnacousticmodeling_tpu.ops import features as jf
from nnacousticmodeling_tpu_torch import kernels
from nnacousticmodeling_tpu_torch.ops import features as tf

ATOL = 1e-3


@pytest.mark.parametrize("n", [0, 399, 400, 559, 560, 16000])
def test_num_frames(n):
    assert tf.num_frames(n) == jf.num_frames(n)
    assert tf.num_frames(n, 200, 80) == jf.num_frames(n, 200, 80)


@pytest.mark.parametrize("kaldi_weights", [False, True])
def test_tables_equal(kaldi_weights):
    np.testing.assert_array_equal(tf.povey_window(), jf.povey_window())
    np.testing.assert_array_equal(tf.povey_window(256), jf.povey_window(256))
    np.testing.assert_array_equal(
        tf.mel_filterbank(kaldi_weights=kaldi_weights),
        jf.mel_filterbank(kaldi_weights=kaldi_weights))
    np.testing.assert_array_equal(
        tf.mel_filterbank(23, 256, 8000, 64.0, 3800.0, kaldi_weights),
        jf.mel_filterbank(23, 256, 8000, 64.0, 3800.0, kaldi_weights))
    for a, b in zip(tf.dft_bases(), jf.dft_bases()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tf.dct_matrix(), jf.dct_matrix())
    np.testing.assert_array_equal(tf.dct_matrix(20, 30),
                                  jf.dct_matrix(20, 30))


@pytest.mark.parametrize("n,preemph", [(400, 0.97), (12345, 0.97),
                                       (8000, 0.0)])
def test_frame_signal_bit_equal(n, preemph):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got = tf.frame_signal(torch.from_numpy(x), preemph=preemph).numpy()
    want = np.asarray(jf.frame_signal(jnp.asarray(x), preemph=preemph))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kaldi_weights", [False, True])
@pytest.mark.parametrize("n", [12000, 16000 + 77])
def test_fbank_matches_jax(n, kaldi_weights):
    x = (np.random.default_rng(n).standard_normal(n) * 0.1
         ).astype(np.float32)
    before = dict(kernels.launches)
    got = tf.fbank_cuda(x, kaldi_weights=kaldi_weights, device="cpu")
    assert dict(kernels.launches) == before
    plain = tf.fbank(torch.from_numpy(x), kaldi_weights=kaldi_weights)
    assert torch.equal(got, plain)
    got = got.numpy()
    want_k = np.asarray(jf.fbank_pallas(jnp.asarray(x), block_frames=32,
                                        interpret=True,
                                        kaldi_weights=kaldi_weights))
    want = np.asarray(jf.fbank(jnp.asarray(x), kaldi_weights=kaldi_weights))
    assert got.shape == want.shape == (tf.num_frames(n), tf.NUM_MEL)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want_k, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kaldi_weights", [False, True])
def test_fbank_short_waveform_has_no_frames(kaldi_weights):
    x = np.zeros(399, np.float32)
    got = tf.fbank_cuda(x, kaldi_weights=kaldi_weights, device="cpu")
    want = np.asarray(jf.fbank_pallas(jnp.asarray(x), interpret=True,
                                      kaldi_weights=kaldi_weights))
    assert got.shape == want.shape == (0, tf.NUM_MEL)
    assert tf.fbank(x, kaldi_weights=kaldi_weights,
                    device="cpu").shape == (0, tf.NUM_MEL)


def test_fbank_pinned_kaldi_golden():
    """The JAX package's pinned Kaldi-convention vector holds for the
    port too (tests/test_features.py:187-193)."""
    g = np.load("tests/data/kaldi_fbank_golden.npz")
    y = tf.fbank(g["x"], kaldi_weights=True, device="cpu").numpy()
    np.testing.assert_allclose(y, g["y"], atol=1e-4, rtol=0)


@pytest.mark.parametrize("num_ceps", [13, 20])
def test_mfcc_matches_jax(num_ceps):
    x = (np.random.default_rng(3).standard_normal(8000) * 0.2
         ).astype(np.float32)
    got = tf.mfcc(x, num_ceps, device="cpu").numpy()
    want = np.asarray(jf.mfcc(jnp.asarray(x), num_ceps))
    assert got.shape == want.shape == (tf.num_frames(8000), num_ceps)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("var_norm", [False, True])
def test_cmn_matches_jax(var_norm):
    x = (np.random.default_rng(4).standard_normal((50, 13)) + 3.0
         ).astype(np.float32)
    got = tf.cmn(torch.from_numpy(x), var_norm=var_norm).numpy()
    want = np.asarray(jf.cmn(jnp.asarray(x), var_norm=var_norm))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.mean(axis=0), 0.0, atol=1e-5)


@pytest.mark.parametrize("var_norm", [False, True])
def test_cmn_per_speaker_equal(var_norm):
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((30, 4)).astype(np.float32)
    feats[:20] += 5.0
    offsets = np.array([0, 10, 20, 30])
    speakers = np.array([0, 0, 1])
    np.testing.assert_array_equal(
        tf.cmn_per_speaker(feats, offsets, speakers, var_norm),
        jf.cmn_per_speaker(feats, offsets, speakers, var_norm))


def test_kernel_wrapper_refuses_cpu_frames():
    with pytest.raises(ValueError, match="CUDA"):
        tf.fbank_frames(torch.zeros(3, tf.FRAME_LEN))
