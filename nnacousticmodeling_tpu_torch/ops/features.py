"""Raw-audio feature extraction: STFT -> log-mel fbank -> MFCC, + CMN.

Counterpart of ``nnacousticmodeling_tpu/ops/features.py``, with the same
conventions (Kaldi framing with snip-edges, per-frame preemphasis with
the first-sample self-subtraction, the Povey window, the float32-epsilon
log floor; HTK-style integer-bin mel triangles by default,
``kaldi_weights=True`` for Kaldi's continuous mel-domain weights) and
the same numpy tables, copied here so the port needs no JAX.

Two implementations with one function:

* ``fbank``: plain PyTorch (framing by ``unfold``, window, DFT as two
  ``torch.matmul`` products, power, mel product, log). On the card its
  products run in full float32 (TF32 off, as ``resolve_device`` sets);
* ``fbank_cuda``: the counterpart of the JAX package's ``fbank_pallas``,
  one hand-written kernel (``csrc/fbank.cu``) for a CUDA waveform:
  framing, preemphasis, window, a 512-point real FFT (two 16-point
  passes in registers, one transpose through shared memory), power,
  the mel bands and log. ``fbank_frames`` runs the same kernel
  on frames already cut by ``frame_signal``. A CPU waveform takes
  ``fbank``.

Waveforms may be numpy arrays or tensors; a numpy waveform goes to
``device`` (``cuda`` unless ``device="cpu"`` is given).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..utils.device import resolve_device

SAMPLE_RATE = 16000
FRAME_LEN = 400      # 25 ms
FRAME_HOP = 160      # 10 ms
NFFT = 512
NUM_MEL = 40
NUM_CEPS = 13
PREEMPH = 0.97
EPS = 1.1921e-07     # float32 epsilon, Kaldi's log floor


def num_frames(num_samples: int, frame_len: int = FRAME_LEN,
               hop: int = FRAME_HOP) -> int:
    if num_samples < frame_len:
        return 0
    return 1 + (num_samples - frame_len) // hop


def povey_window(frame_len: int = FRAME_LEN) -> np.ndarray:
    """Kaldi's default window: Hann^0.85."""
    n = np.arange(frame_len)
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * n / (frame_len - 1))
    return (hann ** 0.85).astype(np.float32)


def mel_filterbank(num_mel: int = NUM_MEL, nfft: int = NFFT,
                   sample_rate: int = SAMPLE_RATE,
                   low_freq: float = 20.0,
                   high_freq: Optional[float] = None,
                   kaldi_weights: bool = False) -> np.ndarray:
    """(nfft//2+1, num_mel) triangular mel weights: HTK-style triangles
    snapped to integer FFT bins, or with ``kaldi_weights`` Kaldi's
    triangles evaluated in the continuous mel domain at each FFT bin's
    mel frequency."""
    if high_freq is None:
        high_freq = sample_rate / 2.0

    def to_mel(f):
        return 1127.0 * np.log(1.0 + f / 700.0)

    def from_mel(m):
        return 700.0 * (np.exp(m / 1127.0) - 1.0)

    if kaldi_weights:
        mel_lo, mel_hi = to_mel(low_freq), to_mel(high_freq)
        delta = (mel_hi - mel_lo) / (num_mel + 1)
        left = mel_lo + np.arange(num_mel) * delta     # per-bin triangle
        bin_mels = to_mel(np.arange(nfft // 2 + 1) * sample_rate / nfft)
        up = (bin_mels[:, None] - left[None, :]) / delta
        down = ((left[None, :] + 2 * delta) - bin_mels[:, None]) / delta
        fb = np.minimum(up, down)
        return np.where(fb > 0.0, fb, 0.0).astype(np.float32)

    mel_pts = np.linspace(to_mel(low_freq), to_mel(high_freq), num_mel + 2)
    hz_pts = from_mel(mel_pts)
    bins = np.floor((nfft + 1) * hz_pts / sample_rate).astype(int)
    fb = np.zeros((nfft // 2 + 1, num_mel), dtype=np.float32)
    for m in range(1, num_mel + 1):
        lo, ctr, hi = bins[m - 1], bins[m], bins[m + 1]
        for k in range(lo, ctr):
            if ctr > lo:
                fb[k, m - 1] = (k - lo) / (ctr - lo)
        for k in range(ctr, hi):
            if hi > ctr:
                fb[k, m - 1] = (hi - k) / (hi - ctr)
    return fb


def dft_bases(frame_len: int = FRAME_LEN, nfft: int = NFFT
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT bases (frame_len, nfft//2+1) for power spectra as
    two products (zero-padding folded into the basis truncation)."""
    k = np.arange(nfft // 2 + 1)
    n = np.arange(frame_len)
    ang = -2.0 * np.pi * np.outer(n, k) / nfft
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


def dct_matrix(num_ceps: int = NUM_CEPS, num_mel: int = NUM_MEL) -> np.ndarray:
    """Orthonormal DCT-II (num_mel, num_ceps)."""
    m = np.arange(num_mel)
    out = np.zeros((num_mel, num_ceps), dtype=np.float32)
    for c in range(num_ceps):
        out[:, c] = np.cos(np.pi * c * (2 * m + 1) / (2 * num_mel))
    out[:, 0] *= 1.0 / np.sqrt(num_mel)
    out[:, 1:] *= np.sqrt(2.0 / num_mel)
    return out


def _waveform(x, device) -> torch.Tensor:
    """A float32 tensor: ``x`` itself if it is a tensor, else ``x`` moved
    to ``device``."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            resolve_device(x.device)            # TF32 off for the products
        return x.float()
    return torch.as_tensor(np.asarray(x, dtype=np.float32),
                           device=resolve_device(device))


def frame_signal(x: torch.Tensor, frame_len: int = FRAME_LEN,
                 hop: int = FRAME_HOP, preemph: float = PREEMPH
                 ) -> torch.Tensor:
    """(num_samples,) -> (T, frame_len) with per-frame preemphasis."""
    t = num_frames(x.shape[0], frame_len, hop)
    frames = x[:(t - 1) * hop + frame_len].unfold(0, frame_len, hop) \
        if t else x.new_zeros((0, frame_len))
    if preemph > 0:
        prev = torch.cat([frames[:, :1], frames[:, :-1]], dim=1)
        frames = frames - preemph * prev
    return frames.contiguous()


def fbank(x, frame_len: int = FRAME_LEN, hop: int = FRAME_HOP,
          nfft: int = NFFT, num_mel: int = NUM_MEL,
          kaldi_weights: bool = False, device="cuda") -> torch.Tensor:
    """(num_samples,) waveform -> (T, num_mel) log-mel energies (the
    plain version of ``fbank_cuda``)."""
    x = _waveform(x, device)
    return fbank_frames_reference(frame_signal(x, frame_len, hop), nfft,
                                  num_mel, kaldi_weights)


def fbank_frames_reference(frames: torch.Tensor, nfft: int = NFFT,
                           num_mel: int = NUM_MEL,
                           kaldi_weights: bool = False) -> torch.Tensor:
    """Plain version of the kernel: preemphasised frames (T, frame_len)
    -> (T, num_mel): window, DFT products, power, mel product, log."""
    as_t = lambda a: torch.as_tensor(a, device=frames.device)  # noqa: E731
    frame_len = frames.shape[1]
    frames = frames * as_t(povey_window(frame_len))
    cos_b, sin_b = dft_bases(frame_len, nfft)
    re = frames @ as_t(cos_b)
    im = frames @ as_t(sin_b)
    power = re * re + im * im
    mel = power @ as_t(mel_filterbank(num_mel, nfft,
                                      kaldi_weights=kaldi_weights))
    return torch.log(torch.clamp_min(mel, EPS))


def mfcc(x, num_ceps: int = NUM_CEPS, kaldi_weights: bool = False,
         device="cuda") -> torch.Tensor:
    """(num_samples,) waveform -> (T, num_ceps) cepstra; the log-mel
    energies of a CUDA waveform come from the ``fbank_cuda`` kernel."""
    logmel = fbank_cuda(x, kaldi_weights=kaldi_weights, device=device)
    return logmel @ torch.as_tensor(dct_matrix(num_ceps),
                                    device=logmel.device)


def cmn(features, var_norm: bool = False) -> torch.Tensor:
    """Per-utterance cepstral mean (and optional variance)
    normalization."""
    features = torch.as_tensor(features)
    mu = features.mean(dim=0, keepdim=True)
    out = features - mu
    if var_norm:
        out = out / torch.clamp_min(
            features.std(dim=0, keepdim=True, correction=0), 1e-5)
    return out


def cmn_per_speaker(features: np.ndarray, offsets: np.ndarray,
                    speakers: np.ndarray, var_norm: bool = False
                    ) -> np.ndarray:
    """CMN with statistics pooled over each speaker's utterances
    (the reference's mfcc_cmn_perspk feature variant).

    ``speakers[u]`` is an integer speaker id per utterance.
    """
    out = np.array(features, dtype=np.float32, copy=True)
    for spk in np.unique(speakers):
        rows = np.concatenate([
            np.arange(offsets[u], offsets[u + 1])
            for u in np.nonzero(speakers == spk)[0]])
        mu = out[rows].mean(axis=0, keepdims=True)
        out[rows] -= mu
        if var_norm:
            out[rows] /= np.maximum(out[rows].std(axis=0, keepdims=True), 1e-5)
    return out


# ---------------------------------------------------------------------------
# the hand-written kernel
# ---------------------------------------------------------------------------

FBANK_FRAMES_PER_BLOCK = 4    # csrc/fbank.cu FRAMES
FBANK_LANES = 16              # csrc/fbank.cu LANES: threads a frame
FBANK_MEL_CHUNK = 8           # csrc/fbank.cu MEL_CHUNK: L's multiple


def fft_twiddles() -> np.ndarray:
    """(512, 2) float32 ``cos`` and ``sin`` of ``-2 pi e / 512``, e = 0
    .. 511: computed in float64, rounded to float32 once. The kernel's
    split step reads W512^k, its 16-point DFTs W16^e as entry 32e."""
    ang = -2.0 * np.pi * np.arange(NFFT) / NFFT
    return np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


def pass_twiddles() -> np.ndarray:
    """(16, 16, 2) float32: entry [k1][t] is W256^(t k1), the twiddle
    between the kernel's two 16-point passes; a copy of the entries
    2 t k1 of ``fft_twiddles()``."""
    k1, t = np.meshgrid(np.arange(FBANK_LANES), np.arange(FBANK_LANES),
                        indexing="ij")
    return fft_twiddles()[(2 * k1 * t) % NFFT]


def mel_bands(fb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """A mel bank (nbins, num_mel) as bands: int32 (num_mel, 3) rows of
    (first bin, length, offset into the weights) and the float32 weights
    of every band, each from its first to its last nonzero bin in
    ascending order (a filter with no nonzero has length 0)."""
    rows, weights, off = [], [], 0
    for col in np.asarray(fb, np.float32).T:
        nz = np.flatnonzero(col)
        start, length = (int(nz[0]), int(nz[-1] - nz[0] + 1)) if nz.size \
            else (0, 0)
        rows.append((start, length, off))
        weights.append(col[start:start + length])
        off += length
    return (np.asarray(rows, np.int32).reshape(-1, 3),
            np.concatenate(weights).astype(np.float32))


MEL_END = 1 << 15             # a term code's flag: the band's last term


def mel_lanes(bands: np.ndarray, weights: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    """``mel_bands``' bands packed into 16 term lists of about equal
    length, one for each of the kernel's lanes of a frame: int32 codes
    and float32 weights, both (L, 16), term j of lane t at [j, t]. A code
    is ``bin | m << 9``, plus ``MEL_END`` on band m's last term; the
    bands go to lanes longest first, each to the shortest list (a band
    of length 0 takes one term of weight 0); each lane's bands in
    ascending m, each band's terms in ascending bins; lists padded with
    (bin 0, weight 0) terms to a length L that is a multiple of
    ``FBANK_MEL_CHUNK``."""
    lengths = np.maximum(bands[:, 1], 1)
    lists = [[] for _ in range(FBANK_LANES)]
    for m in sorted(range(len(bands)), key=lambda m: (-lengths[m], m)):
        min(lists, key=lambda terms: sum(lengths[b] for b in terms)
            ).append(m)
    size = max(sum(lengths[m] for m in terms) for terms in lists)
    size = -(-size // FBANK_MEL_CHUNK) * FBANK_MEL_CHUNK
    codes = np.zeros((size, FBANK_LANES), np.int32)
    wts = np.zeros((size, FBANK_LANES), np.float32)
    for lane, terms in enumerate(lists):
        j = 0
        for m in sorted(terms):
            start, length, off = (int(v) for v in bands[m])
            for i in range(max(length, 1)):
                codes[j, lane] = (start + i) | m << 9 | (
                    MEL_END if i == max(length, 1) - 1 else 0)
                wts[j, lane] = weights[off + i] if length else 0.0
                j += 1
    return codes, wts


@dataclass(frozen=True)
class FbankPlan:
    """The kernel's grid for ``frames`` frames: block b computes frames
    ``b * frames_per_block`` up to the next block's first or ``frames``,
    and on the waveform entry reads the samples those frames span."""
    frames: int
    frames_per_block: int = FBANK_FRAMES_PER_BLOCK

    @property
    def blocks(self) -> int:
        return -(-self.frames // self.frames_per_block)

    def block_frames(self, b: int) -> range:
        first = b * self.frames_per_block
        return range(first, min(first + self.frames_per_block, self.frames))

    def block_samples(self, b: int) -> range:
        fr = self.block_frames(b)
        return range(fr[0] * FRAME_HOP, fr[-1] * FRAME_HOP + FRAME_LEN)


_tables: Dict[Tuple[str, bool], Tuple[torch.Tensor, ...]] = {}


def _kernel_tables(device: torch.device, kaldi_weights: bool):
    """Window, twiddles, pass twiddles and the mel lanes' terms (each a
    code and its weight's bits, int32 (L, 16, 2)) on ``device``, built
    once."""
    key = (str(device), bool(kaldi_weights))
    if key not in _tables:
        codes, wts = mel_lanes(*mel_bands(mel_filterbank(
            kaldi_weights=kaldi_weights)))
        terms = np.stack([codes, wts.view(np.int32)], axis=-1)
        _tables[key] = tuple(
            torch.as_tensor(np.ascontiguousarray(a), device=device)
            for a in (povey_window(), fft_twiddles(), pass_twiddles(),
                      terms))
    return _tables[key]


def _lib():
    lib = kernels.load("fbank")
    lib.fbank_forward.argtypes = (
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
        + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3
        + [ctypes.c_void_p])
    lib.fbank_forward.restype = ctypes.c_int
    return lib


def _launch(src: torch.Tensor, t: int, from_wave: bool,
            kaldi_weights: bool) -> torch.Tensor:
    out = torch.empty((t, NUM_MEL), dtype=torch.float32, device=src.device)
    if t == 0:
        return out
    plan = FbankPlan(t)
    win, tw, tw1, terms = _kernel_tables(src.device, kaldi_weights)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    status = _lib().fbank_forward(
        src.data_ptr(), int(from_wave), win.data_ptr(), tw.data_ptr(),
        tw1.data_ptr(), terms.data_ptr(), terms.shape[0],
        out.data_ptr(), t, plan.blocks, plan.frames_per_block, stream)
    kernels.check(status, "fbank")
    kernels.launches["fbank"] += 1
    return out


def fbank_frames(frames: torch.Tensor, kaldi_weights: bool = False
                 ) -> torch.Tensor:
    """CUDA kernel wrapper (``csrc/fbank.cu``): preemphasised frames
    (T, 400) float32 -> (T, 40) log-mel energies: window, real FFT,
    power, mel bands, ``log(max(., EPS))``."""
    if frames.device.type != "cuda":
        raise ValueError(f"fbank_frames: frames on {frames.device}, needs "
                         f"a CUDA tensor")
    if frames.dtype != torch.float32 or frames.dim() != 2 \
            or frames.shape[1] != FRAME_LEN:
        raise ValueError(f"fbank_frames: frames must be float32 (T, "
                         f"{FRAME_LEN}), got {frames.dtype} "
                         f"{tuple(frames.shape)}")
    if not frames.is_contiguous():
        raise ValueError("fbank_frames: frames must be contiguous")
    return _launch(frames, frames.shape[0], False, kaldi_weights)


def fbank_cuda(x, kaldi_weights: bool = False, device="cuda"
               ) -> torch.Tensor:
    """Counterpart of the JAX package's ``fbank_pallas``: (num_samples,)
    waveform -> (T, 40) log-mel energies. A CUDA waveform goes through
    the kernel, which frames it itself, or raises; a CPU waveform takes
    the plain ``fbank``."""
    x = _waveform(x, device)
    if x.device.type == "cpu":
        return fbank(x, kaldi_weights=kaldi_weights)
    if x.dim() != 1:
        raise ValueError(f"fbank_cuda: waveform must be 1-D, got "
                         f"{tuple(x.shape)}")
    return _launch(x.contiguous(), num_frames(x.shape[0]), True,
                   kaldi_weights)
