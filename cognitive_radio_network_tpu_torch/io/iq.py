"""Recorded-IQ files with resumable stream cursors.

Format: raw interleaved float32 I/Q pairs (the de-facto SDR capture format,
compatible with what a USRP capture of the reference's fc=833 MHz / 13 MS/s
band would produce) plus a JSON sidecar with metadata (rate, center, dtype).
Readers yield the framework's canonical planes blocks and can checkpoint /
resume their sample cursor mid-file — the stream analog of training-step
checkpointing for long captures.

Copied from ``cognitive_radio_network_tpu/io/iq.py`` (numpy only), so the
two packages read and write byte-identical captures;
``IQReader.prefetch_blocks`` streams through the port's native prefetcher.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

__all__ = ["IQWriter", "IQReader", "StreamCursor"]


@dataclasses.dataclass
class StreamCursor:
    sample_index: int = 0

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps({"sample_index": self.sample_index}))

    @staticmethod
    def load(path: str | Path) -> "StreamCursor":
        return StreamCursor(**json.loads(Path(path).read_text()))


class IQWriter:
    def __init__(
        self,
        path: str | Path,
        sample_rate_hz: float,
        center_hz: float,
    ):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "wb")
        self.meta = {
            "sample_rate_hz": sample_rate_hz,
            "center_hz": center_hz,
            "dtype": "complex64_interleaved_f32",
        }
        Path(str(self.path) + ".json").write_text(json.dumps(self.meta))

    def write(self, iq: np.ndarray) -> None:
        """iq: complex64 (n,) or float32 planes (n, 2)."""
        if np.iscomplexobj(iq):
            planes = np.stack([iq.real, iq.imag], axis=-1).astype(np.float32)
        else:
            planes = np.asarray(iq, np.float32)
        self._f.write(planes.tobytes())

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class IQReader:
    def __init__(self, path: str | Path, cursor: StreamCursor | None = None):
        self.path = Path(path)
        side = Path(str(self.path) + ".json")
        self.meta = json.loads(side.read_text()) if side.exists() else {}
        self.cursor = cursor or StreamCursor()
        self._size = self.path.stat().st_size // 8  # samples (2 x f32)

    @property
    def sample_rate_hz(self) -> float:
        return float(self.meta.get("sample_rate_hz", 0.0))

    @property
    def center_hz(self) -> float:
        return float(self.meta.get("center_hz", 0.0))

    @property
    def num_samples(self) -> int:
        return self._size

    def read(self, n: int, *, as_planes: bool = True) -> np.ndarray | None:
        """Next n samples from the cursor; None at end of file."""
        if self.cursor.sample_index >= self._size:
            return None
        n = min(n, self._size - self.cursor.sample_index)
        with open(self.path, "rb") as f:
            f.seek(self.cursor.sample_index * 8)
            raw = np.frombuffer(f.read(n * 8), np.float32).reshape(-1, 2)
        self.cursor.sample_index += n
        if as_planes:
            return raw
        return (raw[:, 0] + 1j * raw[:, 1]).astype(np.complex64)

    def blocks(self, block_len: int, *, as_planes: bool = True):
        while True:
            b = self.read(block_len, as_planes=as_planes)
            if b is None or len(b) < block_len:
                return
            yield b

    def prefetch_blocks(self, block_len: int, *, depth: int = 8, loop: bool = False):
        """Like :meth:`blocks`, but through the native prefetching stream
        (mmap + slab ring + background reader thread, native/src/iq_stream.cpp)
        when the native library is available, so the consumer — typically the
        host loop feeding the card — never blocks on file I/O.  Falls back to
        the synchronous Python reader.  Keeps ``self.cursor`` resumable."""
        from cognitive_radio_network_tpu_torch import native

        if not native.available():
            if loop:
                raise NotImplementedError("loop=True requires the native stream")
            yield from self.blocks(block_len)
            return
        with native.NativeIQStream(
            self.path,
            block_len,
            depth=depth,
            start_sample=self.cursor.sample_index,
            loop=loop,
        ) as s:
            for b in s.blocks():
                self.cursor.sample_index = s.cursor
                yield b
