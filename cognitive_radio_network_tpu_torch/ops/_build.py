"""Build and load the CUDA kernels of ``csrc/`` (nvcc -> shared library -> ctypes).

The sources compile at first use into ``build/kernels/`` at the root of the
checkout, under a name keyed by a hash of the sources and flags, so an edit
rebuilds and an unchanged tree reuses the library.  The library has a plain
C interface: no PyTorch headers, so a build takes seconds, not minutes.
Pointers and the stream pass as ``c_void_p``, ints as ``c_int`` (64-bit
lengths as ``c_longlong``); each entry
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
)

# entry point -> argtypes; restype is c_int (a cudaError_t) for all
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # xr, xi, is_bf16, tw, band, avg, feats, cycles, averaging, stream
    "crn_fused_sense_ct": (_P, _P, _I, _P, _P, _P, _P, _I, _I, _P),
    # rr, ri, offsets, out_r, out_i, n, k, wlen, stream
    "crn_extract_windows": (_P, _P, _P, _P, _P, _L, _I, _I, _P),
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


def build(out: Path, extra_flags: tuple[str, ...] = ()) -> subprocess.CompletedProcess:
    """Compile every ``csrc/*.cu`` into ``out``; raises with nvcc's output on failure.

    The library is written under a temporary name and renamed into place, so
    a concurrent loader never sees a partial file."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return proc


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The kernel library, built first if this tree's sources have no build yet."""
    path = library_path()
    if not path.exists():
        build(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
