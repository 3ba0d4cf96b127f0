"""Build and load the CUDA kernels of ``csrc/`` (nvcc -> shared library -> ctypes).

The sources compile at first use into ``build/kernels/`` at the root of the
checkout, under a name keyed by a hash of the sources and flags, so an edit
rebuilds and an unchanged tree reuses the library; N processes that start on
a fresh checkout run one ``nvcc`` (``utils/build.py``).  The library has a plain
C interface: no PyTorch headers, so a build takes seconds, not minutes.
Pointers and the stream pass as ``c_void_p``, ints as ``c_int`` (64-bit
lengths as ``c_longlong``, a threshold as ``c_float``); each entry
point returns ``cudaGetLastError()`` after its launch.

Nothing here runs at import: the CPU-only test machines have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from cognitive_radio_network_tpu_torch.utils.build import build_once

__all__ = ["NVCC_FLAGS", "build", "library_path", "load"]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "--threads",  # the sources compile side by side, as many at once as there are cores
    "0",
)

# entry point -> argtypes; restype is c_int (a cudaError_t) for all
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # xr, xi, is_bf16, tw, band, avg, feats, cycles, averaging, stream
    "crn_fused_sense_ct": (_P, _P, _I, _P, _P, _P, _P, _I, _I, _P),
    # rr, ri, offsets, offsets_i32, n, k, count, then (out_r, out_i, wlen) for
    # each of 4 sets (the unused ones null and 0), stream
    "crn_extract_window_sets": (_P, _P, _P, _I, _L, _I, _I, *(_P, _P, _I) * 4, _P),
    # xr, xi (null: interleaved), their stream strides, hist_r, hist_i (null:
    # none), their stream strides, taps, tw, out, batch, cycles, block_len,
    # interleaved, stream
    "crn_fused_wideband": (_P, _P, _L, _L, _P, _P, _L, _L, _P, _P, _P, _I, _L, _I, _I, _P),
    # xr, xi, tw, band, feats, cycles, averaging, stream
    "crn_fused_sense": (_P, _P, _P, _P, _P, _I, _I, _P),
    # offs, peaks, ok, flen, keep0, accept, meta, k, thr, n, prefix, stream
    "crn_resolve_candidates": (_P, _P, _P, _P, _P, _P, _P, _I, _F, _L, _L, _P),
}


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))  # the toolkit's default prefix
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / f"libcrn_kernels_{h.hexdigest()[:16]}.so"


def _compile(tmp: Path, extra_flags: tuple[str, ...] = ()) -> subprocess.CompletedProcess:
    """One nvcc call over every ``csrc/*.cu`` into ``tmp``; raises with nvcc's output on failure."""
    cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    return proc


def build(out: Path, extra_flags: tuple[str, ...] = ()) -> subprocess.CompletedProcess | None:
    """Compile every ``csrc/*.cu`` into ``out`` unless it exists (``utils/build.py``:
    one build however many processes ask, under a lock in ``build/kernels/``,
    renamed into place).  Returns nvcc's result, or None when ``out`` was there."""
    return build_once(out, lambda tmp: _compile(tmp, extra_flags))


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The kernel library, built first if this tree's sources have no build yet."""
    path = library_path()
    build(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
