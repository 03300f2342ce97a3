"""Build, load and count the hand-written CUDA kernels in ``csrc/``.

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded through ``ctypes``; nothing includes PyTorch's
headers, so a build takes seconds. Libraries go to ``build/kernels/``
at the repository root (ignored by git), named by a hash of the source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source
or header is rebuilt and never confused with a stale library. Builds
happen at first use or through ``build()``, never at import.

``launches`` counts, per kernel name, the wrapper calls that launched
the kernel on the card; a kernel with two routes counts them apart
(``collapsed_viterbi_forward`` and ``collapsed_viterbi_forward.global``).
Calls that took the plain PyTorch version (CPU tensors) do not count.
Under CUDA graph capture a wrapper call launches nothing: ``capturing``
holds the counts of such calls apart, and ``replayed`` adds them once
for each replay of the graph, so the counts keep their meaning.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, Optional

from .utils.profiling import span

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = {
    "ctc_loss": "ctc_loss.cu",
    "fbank": "fbank.cu",
    "gated_scan": "gated_scan.cu",
    "gated_train": "gated_train.cu",
    "lstm_scan": "lstm_scan.cu",
    "lstm_train": "lstm_train.cu",
    "peephole_scan": "peephole_scan.cu",
    "peephole_train": "peephole_train.cu",
    "viterbi_backtrace": "viterbi_backtrace.cu",
    "viterbi_collapsed": "viterbi_collapsed.cu",
    "viterbi_cube": "viterbi_cube.cu",
    "viterbi_scan": "viterbi_scan.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC"]

launches: Counter = Counter()
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    launches.clear()


@contextlib.contextmanager
def capturing():
    """Count the wrapper calls made inside (a CUDA graph capture) apart:
    on exit they are taken out of ``launches`` and left in the yielded
    Counter, the launches one replay of the graph makes."""
    before = launches.copy()
    made: Counter = Counter()
    try:
        yield made
    finally:
        for name, n in launches.items():
            if n != before[name]:
                made[name] = n - before[name]
        launches.clear()
        launches.update(before)


def replayed(made: Counter) -> None:
    """Count the launches of one replay of a graph (``capturing``'s
    Counter)."""
    launches.update(made)


def _nvcc() -> str:
    cands = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(Path(os.environ[var]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: install the CUDA toolkit or set "
                       "CUDA_HOME")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest = digest.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernels (default: all), one ``nvcc`` per source,
    all started together. Returns each fresh build's compiler report
    (``-Xptxas -v``: registers, shared memory, spills)."""
    names = list(names) if names is not None else list(SOURCES)
    stale = [n for n in names if not library_path(n).is_file()]
    if not stale:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    reports = {}
    with span("nnam.kernels.build"):
        procs = {}
        for name in stale:
            so = library_path(name)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
                   str(CSRC / SOURCES[name])]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, so)
        for name, (proc, tmp, so) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{out}")
            os.replace(tmp, so)
            reports[name] = out
    return reports


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def check(status: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")
