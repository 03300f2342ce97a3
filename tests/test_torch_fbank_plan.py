"""The host side of the ``fbank`` kernel (``csrc/fbank.cu``), on the CPU.

The tables the kernel reads (mel bands and the lanes' term lists,
twiddles) and the block plan its grid follows, and a numpy model of its
arithmetic: the same packing, the same two 16-point passes (two radix-4
levels each) with the same twiddle entries, the same transpose, the same
paired split step and the same lane term lists. The model's spectrum
must match ``np.fft.rfft`` of the windowed frames to 1e-5 of each
frame's largest magnitude (float32 arithmetic: observed ~1e-7), and its
log-mel output the JAX package's ``fbank_pallas`` (interpret mode)
within the 1e-3 log-domain tolerance of the JAX kernel test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnacousticmodeling_tpu.ops import features as jf
from nnacousticmodeling_tpu_torch.ops import features as tf

MEL_CASES = [dict(kaldi_weights=False), dict(kaldi_weights=True),
             dict(num_mel=23, nfft=256, sample_rate=8000, low_freq=64.0,
                  high_freq=3800.0, kaldi_weights=False),
             dict(num_mel=23, nfft=256, sample_rate=8000, low_freq=64.0,
                  high_freq=3800.0, kaldi_weights=True)]


def _dense(bands, weights, nbins):
    fb = np.zeros((nbins, bands.shape[0]), np.float32)
    for m, (start, length, off) in enumerate(bands):
        fb[start:start + length, m] = weights[off:off + length]
    return fb


@pytest.mark.parametrize("case", MEL_CASES, ids=str)
def test_mel_bands_rebuild_the_bank(case):
    fb = tf.mel_filterbank(**case)
    bands, weights = tf.mel_bands(fb)
    assert bands.dtype == np.int32 and weights.dtype == np.float32
    assert bands.shape == (fb.shape[1], 3)
    np.testing.assert_array_equal(_dense(bands, weights, fb.shape[0]), fb)
    np.testing.assert_array_equal(
        fb, jf.mel_filterbank(**case))
    # bands are packed back to back, and each starts and ends on a nonzero
    np.testing.assert_array_equal(bands[:, 2],
                                  np.concatenate([[0], np.cumsum(
                                      bands[:-1, 1])]))
    assert weights.size == bands[:, 1].sum()
    for start, length, off in bands:
        if length:
            assert weights[off] != 0 and weights[off + length - 1] != 0


@pytest.mark.parametrize("kaldi_weights,nonzeros", [(False, 454),
                                                    (True, 492)])
def test_mel_bands_of_the_kernel(kaldi_weights, nonzeros):
    """The 40-filter banks the kernel reads: one contiguous run of at most
    31 bins each, between bins 1 and 255."""
    bands, weights = tf.mel_bands(tf.mel_filterbank(
        kaldi_weights=kaldi_weights))
    assert weights.size == np.count_nonzero(weights) == nonzeros
    assert bands[:, 1].min() >= 1 and bands[:, 1].max() <= 31
    assert bands[:, 0].min() >= 1 and (bands[:, 0] + bands[:, 1]).max() <= 256


def test_mel_bands_of_an_empty_filter():
    fb = np.zeros((9, 3), np.float32)
    fb[2:5, 0] = [0.5, 1.0, 0.5]
    fb[6:8, 2] = [1.0, 0.25]
    bands, weights = tf.mel_bands(fb)
    np.testing.assert_array_equal(bands, [[2, 3, 0], [0, 0, 3], [6, 2, 3]])
    np.testing.assert_array_equal(_dense(bands, weights, 9), fb)


def test_twiddles_are_float64_rounded_once():
    tw = tf.fft_twiddles()
    want = np.exp(-2j * np.pi * np.arange(512, dtype=np.float64) / 512)
    assert tw.dtype == np.float32 and tw.shape == (512, 2)
    np.testing.assert_array_equal(tw[:, 0], want.real.astype(np.float32))
    np.testing.assert_array_equal(tw[:, 1], want.imag.astype(np.float32))


def test_pass_twiddles_are_w256_rounded_once():
    tw1 = tf.pass_twiddles()
    k1, t = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    want = np.exp(-2j * np.pi * ((k1 * t) % 256) / 256)
    assert tw1.dtype == np.float32 and tw1.shape == (16, 16, 2)
    np.testing.assert_array_equal(tw1[..., 0], want.real.astype(np.float32))
    np.testing.assert_array_equal(tw1[..., 1], want.imag.astype(np.float32))


def _lane_length(codes):
    """The longest lane's terms up to its last band's end."""
    return max(np.flatnonzero(codes[:, lane] & tf.MEL_END).max(initial=-1)
               + 1 for lane in range(codes.shape[1]))


def _lane_terms_to_dense(codes, wts, nbins, nmel):
    """Rebuild a bank from lane term lists, checking their structure:
    each band's terms on one lane, in ascending bins, one end each; after
    a lane's last end only padding (code 0, weight 0)."""
    fb = np.zeros((nbins, nmel), np.float32)
    ends = np.zeros(nmel, np.int64)
    assert codes.shape[0] % tf.FBANK_MEL_CHUNK == 0
    for lane in range(codes.shape[1]):
        ends_at = np.flatnonzero(codes[:, lane] & tf.MEL_END)
        used = ends_at.max(initial=-1) + 1
        assert not codes[used:, lane].any() and not wts[used:, lane].any()
        last = None
        for code, w in zip(codes[:used, lane], wts[:used, lane]):
            b, m = code & 511, (code >> 9) & 63
            if last is not None and m == last[0]:
                assert b == last[1] + 1
            if w:
                fb[b, m] = w
            last = (m, b)
            if code & tf.MEL_END:
                ends[m] += 1
                last = None
    np.testing.assert_array_equal(ends, 1)
    return fb


@pytest.mark.parametrize("case", MEL_CASES, ids=str)
def test_mel_lanes_rebuild_the_bank(case):
    fb = tf.mel_filterbank(**case)
    bands, weights = tf.mel_bands(fb)
    codes, wts = tf.mel_lanes(bands, weights)
    assert codes.dtype == np.int32 and wts.dtype == np.float32
    assert codes.shape == wts.shape and codes.shape[1] == tf.FBANK_LANES
    np.testing.assert_array_equal(
        _lane_terms_to_dense(codes, wts, *fb.shape), fb)
    # balanced: no list longer than its longest band or an even share
    total = int(np.maximum(bands[:, 1], 1).sum())
    assert _lane_length(codes) <= max(int(bands[:, 1].max()),
                                      -(-total // tf.FBANK_LANES) + 4)


@pytest.mark.parametrize("kaldi_weights,length", [(False, 31), (True, 32)])
def test_mel_lanes_of_the_kernel(kaldi_weights, length):
    codes, wts = tf.mel_lanes(*tf.mel_bands(tf.mel_filterbank(
        kaldi_weights=kaldi_weights)))
    assert _lane_length(codes) == length
    assert codes.shape == (32, 16)
    np.testing.assert_array_equal(
        _lane_terms_to_dense(codes, wts, 257, 40),
        tf.mel_filterbank(kaldi_weights=kaldi_weights))


def test_mel_lanes_of_an_empty_filter():
    fb = np.zeros((9, 3), np.float32)
    fb[2:5, 0] = [0.5, 1.0, 0.5]
    fb[6:8, 2] = [1.0, 0.25]
    codes, wts = tf.mel_lanes(*tf.mel_bands(fb))
    np.testing.assert_array_equal(_lane_terms_to_dense(codes, wts, 9, 3), fb)
    # the empty filter's one term: bin 0, weight 0, its end
    assert ((codes >> 9) & 63 == 1).sum() == 1


@pytest.mark.parametrize("kaldi_weights", [False, True])
def test_kernel_tables_pack_the_lanes(kaldi_weights):
    """The tables as the kernel gets them: window, twiddles, pass
    twiddles, and each lane term as (code, weight bits)."""
    win, tw, tw1, terms = tf._kernel_tables(torch.device("cpu"),
                                            kaldi_weights)
    np.testing.assert_array_equal(win.numpy(), tf.povey_window())
    np.testing.assert_array_equal(tw.numpy(), tf.fft_twiddles())
    np.testing.assert_array_equal(tw1.numpy(), tf.pass_twiddles())
    codes, wts = tf.mel_lanes(*tf.mel_bands(tf.mel_filterbank(
        kaldi_weights=kaldi_weights)))
    terms = terms.numpy()
    assert terms.dtype == np.int32 and terms.shape == (32, 16, 2)
    np.testing.assert_array_equal(terms[..., 0], codes)
    np.testing.assert_array_equal(terms[..., 1].view(np.float32), wts)


@pytest.mark.parametrize("t", [0, 1, 2, 3, 4, 5, 392, 50221])
def test_block_plan_covers_every_frame_once(t):
    plan = tf.FbankPlan(t)
    assert plan.frames_per_block == tf.FBANK_FRAMES_PER_BLOCK == 4
    assert plan.blocks == -(-t // 4)
    seen = np.zeros(t, np.int64)
    num_samples = tf.FRAME_LEN + tf.FRAME_HOP * (t - 1) if t else 0
    for b in range(plan.blocks):
        frames = plan.block_frames(b)
        assert 1 <= len(frames) <= plan.frames_per_block
        seen[frames.start:frames.stop] += 1
        span = plan.block_samples(b)
        assert span.start == frames.start * tf.FRAME_HOP
        assert len(span) == tf.FRAME_HOP * (len(frames) - 1) + tf.FRAME_LEN
        assert len(span) <= tf.FRAME_HOP * 3 + tf.FRAME_LEN
        assert span.stop <= num_samples
    np.testing.assert_array_equal(seen, 1)
    assert tf.num_frames(num_samples) == t


# ---------------------------------------------------------------------------
# a numpy model of the kernel's arithmetic
# ---------------------------------------------------------------------------

def _radix4(x0, x1, x2, x3):
    t0, t1, t2, t3 = x0 + x2, x0 - x2, x1 + x3, x1 - x3
    return t0 + t2, t1 - 1j * t3, t0 - t2, t1 + 1j * t3


def _dft16(a, w):
    """16-point DFTs over the last axis, as the kernel's dft16: n = 4p + q,
    k = r + 4s; inner radix-4 over p, twiddles w[32 q r], outer over q."""
    u = [_radix4(a[..., q], a[..., 4 + q], a[..., 8 + q], a[..., 12 + q])
         for q in range(4)]
    u = [[u[q][r] * (w[32 * q * r] if q and r else 1) for r in range(4)]
         for q in range(4)]
    out = np.empty_like(a)
    for r in range(4):
        for s_, y in enumerate(_radix4(*(u[q][r] for q in range(4)))):
            out[..., r + 4 * s_] = y
    return out


def _power_model(y, tw, tw1):
    """Windowed frames (T, 400) float32 -> (spectrum (T, 257) complex64,
    power (T, 257) float32), as the kernel computes them."""
    w = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    w1 = (tw1[..., 0] + 1j * tw1[..., 1]).astype(np.complex64)
    yp = np.zeros((y.shape[0], tf.NFFT), np.float32)
    yp[:, :tf.FRAME_LEN] = y
    z = (yp[:, 0::2] + 1j * yp[:, 1::2]).astype(np.complex64)
    # pass 1: thread t transforms z[16 n1 + t] over n1, times W256^(t k1)
    a = _dft16(z.reshape(-1, 16, 16).transpose(0, 2, 1), w)   # [t, k1]
    tile = a.transpose(0, 2, 1) * w1                          # [k1, t]
    # pass 2: thread t transforms row t; Z[t + 16 k2]
    zz = _dft16(tile, w).transpose(0, 2, 1).reshape(-1, 256)
    spec = np.empty((y.shape[0], 257), np.complex64)
    k = np.arange(1, 128)
    r = zz[:, 256 - k]
    s_ = zz[:, k] + np.conj(r)
    wd = (zz[:, k] - np.conj(r)) * w[k]
    spec[:, k] = 0.5 * ((s_.real + wd.imag) + 1j * (s_.imag - wd.real))
    spec[:, 256 - k] = 0.5 * ((s_.real - wd.imag)
                              + 1j * (-s_.imag - wd.real))
    spec[:, 0] = zz[:, 0].real + zz[:, 0].imag
    spec[:, 256] = zz[:, 0].real - zz[:, 0].imag
    spec[:, 128] = np.conj(zz[:, 128])
    power = (spec.real * spec.real + spec.imag * spec.imag).astype(np.float32)
    return spec, power


def _logmel_model(power, codes, wts):
    """The lanes' term lists over the power, as the kernel sums them."""
    out = np.zeros((power.shape[0], 40), np.float32)
    for lane in range(codes.shape[1]):
        acc = np.zeros(power.shape[0], np.float32)
        for code, w in zip(codes[:, lane], wts[:, lane]):
            acc = acc + power[:, code & 511] * w
            if code & tf.MEL_END:
                out[:, (code >> 9) & 63] = acc
                acc[:] = 0.0
    return np.log(np.maximum(out, np.float32(tf.EPS)))


def _windowed(x):
    return (tf.frame_signal(torch.from_numpy(x))
            * torch.from_numpy(tf.povey_window())).numpy()


@pytest.mark.parametrize("n", [400, 1200, 16000 + 77])
def test_stage_schedule_matches_rfft(n):
    x = (np.random.default_rng(n).standard_normal(n) * 0.1
         ).astype(np.float32)
    y = _windowed(x)
    spec, power = _power_model(y, tf.fft_twiddles(), tf.pass_twiddles())
    want = np.fft.rfft(y.astype(np.float64), n=tf.NFFT)
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(spec - want) / scale).max() <= 1e-5
    np.testing.assert_allclose(power, np.abs(want) ** 2, rtol=0,
                               atol=1e-5 * float((scale ** 2).max()))


@pytest.mark.parametrize("kaldi_weights", [False, True])
def test_kernel_model_matches_jax_kernel(kaldi_weights):
    n = 16000 + 77
    x = (np.random.default_rng(12).standard_normal(n) * 0.1
         ).astype(np.float32)
    _, power = _power_model(_windowed(x), tf.fft_twiddles(),
                            tf.pass_twiddles())
    fb = tf.mel_filterbank(kaldi_weights=kaldi_weights)
    codes, wts = tf.mel_lanes(*tf.mel_bands(fb))
    got = _logmel_model(power, codes, wts)
    want = np.asarray(jf.fbank_pallas(jnp.asarray(x), block_frames=32,
                                      interpret=True,
                                      kaldi_weights=kaldi_weights))
    assert got.shape == want.shape == (tf.num_frames(n), tf.NUM_MEL)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    dense = np.log(np.maximum(power @ fb, np.float32(tf.EPS)))
    np.testing.assert_allclose(got, dense, rtol=0, atol=1e-5)
