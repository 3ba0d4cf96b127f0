"""Build a shared library once per checkout, however many processes ask at once.

A distributed run starts one node process per node, and the tests run in
several workers; on a fresh checkout each of them finds no library and would
compile it.  :func:`build_once` serializes them on an exclusive ``flock`` of a
lock file beside the library, taken around "exists? else build": the first
process builds, the others wait and then find the file.  The library is
written under a temporary name and renamed into place, so a loader never maps
a partial file.  The lock is released when its file closes, so a process that
dies while building leaves no stale lock behind.
"""

from __future__ import annotations

import fcntl
import os
from pathlib import Path
from typing import Callable, TypeVar

__all__ = ["build_once"]

T = TypeVar("T")


def build_once(out: Path, compile_to: Callable[[Path], T]) -> T | None:
    """Make ``out`` by ``compile_to(tmp)`` unless it exists.  ``compile_to``
    writes the library at the path it is given and raises on failure.
    Returns its result, or None when ``out`` was already there."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "build.lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return None
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp{out.suffix}")
        try:
            result = compile_to(tmp)
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
        return result
