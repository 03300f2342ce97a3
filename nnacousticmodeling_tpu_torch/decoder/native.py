"""ctypes wrapper for the native host-side decoder (``native/``, the C
API of ``native/src/capi.cc``).

Counterpart of ``nnacousticmodeling_tpu/decoder/native.py``. The card
decoders (``viterbi.py``) are the performance path; this one is the
reference's own decoder rebuilt in C++, run on host threads: a second
decode oracle and ``evaluate --decoder native``. ``native/`` is a C++
project of its own and is used as it is.

``build_native`` compiles its shared library into this package's own
directory, ``build/native/`` at the root of the checkout (git-ignored;
not ``native/build/``, which the JAX package builds), under a file
lock, so that concurrent processes do not race one build. It runs one
``g++`` with ``CMakeLists.txt``'s flags on the library's three sources.
A stamp of the sources' hash makes a changed source rebuild. When
``g++`` is missing or fails it raises: there is no fallback decoder.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional

import numpy as np

from .viterbi import DecodeResult

REPO = Path(__file__).resolve().parents[2]
NATIVE_DIR = REPO / "native"
BUILD_DIR = REPO / "build" / "native"
LIB_PATH = BUILD_DIR / "libnnam_decoder.so"
CXXFLAGS = ["-std=c++17", "-O3", "-march=native", "-fPIC", "-pthread"]


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(NATIVE_DIR.joinpath("src").iterdir()) + [
            NATIVE_DIR / "CMakeLists.txt"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def build_native() -> Path:
    """Build the native library into ``build/native/`` (a no-op when
    built from the current sources) and return its path. Raises
    ``RuntimeError`` when ``g++`` is missing or the build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stamp = BUILD_DIR / "sources.sha256"
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        want = _source_hash()
        if (LIB_PATH.exists() and stamp.exists()
                and stamp.read_text() == want):
            return LIB_PATH
        stamp.unlink(missing_ok=True)
        if not shutil.which("g++"):
            raise RuntimeError("no native toolchain: g++ is not on PATH")
        src = NATIVE_DIR / "src"
        tmp = LIB_PATH.with_name(LIB_PATH.name + ".tmp")
        cmd = ["g++", *CXXFLAGS, "-shared", f"-I{src}", src / "capi.cc",
               src / "matrix_io.cc", src / "decoder.cc", "-o", tmp]
        r = subprocess.run([str(c) for c in cmd], capture_output=True,
                           text=True)
        if r.returncode != 0:
            raise RuntimeError(f"native build {' '.join(map(str, cmd))} "
                               f"failed:\n{r.stdout}{r.stderr}")
        os.replace(tmp, LIB_PATH)
        stamp.write_text(want)
    return LIB_PATH


class NativeDecoder:
    """Host-side decoder over a decoding-image file; ``decode_one`` and
    ``decode_batch`` return this package's ``DecodeResult``."""

    def __init__(self, image_path: str, pip: float = 20.0, lmw: float = 1.0,
                 beam: Optional[float] = None):
        lib = ctypes.CDLL(str(build_native()))
        lib.nnam_decoder_create.restype = ctypes.c_void_p
        lib.nnam_decoder_create.argtypes = [
            ctypes.c_char_p, ctypes.c_float, ctypes.c_float]
        lib.nnam_decoder_decode.restype = ctypes.c_int
        lib.nnam_decoder_decode.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
        lib.nnam_decoder_num_states.restype = ctypes.c_int
        lib.nnam_decoder_num_states.argtypes = [ctypes.c_void_p]
        lib.nnam_decoder_phone_name.restype = ctypes.c_int
        lib.nnam_decoder_phone_name.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.nnam_decoder_destroy.restype = None
        lib.nnam_decoder_destroy.argtypes = [ctypes.c_void_p]
        lib.nnam_decoder_set_beam.restype = None
        lib.nnam_decoder_set_beam.argtypes = [ctypes.c_void_p,
                                              ctypes.c_float]
        lib.nnam_decoder_skipped_updates.restype = ctypes.c_int64
        lib.nnam_decoder_skipped_updates.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self._h = lib.nnam_decoder_create(str(image_path).encode(),
                                          ctypes.c_float(pip),
                                          ctypes.c_float(lmw))
        if not self._h:
            raise RuntimeError(f"cannot load image {image_path}")
        if beam is not None and beam > 0:
            lib.nnam_decoder_set_beam(self._h, ctypes.c_float(beam))
        self.num_states = lib.nnam_decoder_num_states(self._h)
        self._names: dict = {}

    @property
    def skipped_updates(self) -> int:
        """Triphone updates skipped by beam pruning (cumulative)."""
        return int(self._lib.nnam_decoder_skipped_updates(self._h))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.nnam_decoder_destroy(self._h)
            self._h = None

    def _phone_name(self, tri: int) -> str:
        if tri not in self._names:
            buf = ctypes.create_string_buffer(64)
            if self._lib.nnam_decoder_phone_name(self._h, tri, buf, 64) < 0:
                raise ValueError(f"bad triphone {tri}")
            self._names[tri] = buf.value.decode()
        return self._names[tri]

    def decode_one(self, log_probs: np.ndarray) -> DecodeResult:
        """(T, num_states) log posteriors -> the utterance's segments."""
        lp = np.ascontiguousarray(log_probs, dtype=np.float32)
        if lp.ndim != 2:
            raise ValueError(f"posteriors must be (T, S), got {lp.shape}")
        t, s = lp.shape
        if s != self.num_states:
            raise ValueError(f"posterior columns {s} != image states "
                             f"{self.num_states}")
        out = np.zeros((t + 1, 3), dtype=np.int32)
        n = self._lib.nnam_decoder_decode(
            self._h, lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            t, s, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out.shape[0])
        if n < 0:
            raise RuntimeError("native decode failed")
        return DecodeResult(segments=[
            (int(b), int(e), self._phone_name(int(tri)))
            for b, e, tri in out[:n]])

    def decode_batch(self, log_probs: List[np.ndarray],
                     n_threads: Optional[int] = None) -> List[DecodeResult]:
        """Decode many utterances across host cores, in order: the
        decoder's ``Decode`` is const with no shared scratch and ctypes
        releases the GIL for the call (the reference's OpenMP utterance
        loop, main.cpp:51-64)."""
        if n_threads is None:
            n_threads = min(len(log_probs), os.cpu_count() or 1)
        if n_threads <= 1 or len(log_probs) <= 1:
            return [self.decode_one(lp) for lp in log_probs]
        with ThreadPoolExecutor(max_workers=n_threads) as pool:
            return list(pool.map(self.decode_one, log_probs))
