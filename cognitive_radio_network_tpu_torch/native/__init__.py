"""ctypes bindings for the native runtime library (``native/`` at repo root).

Port of ``cognitive_radio_network_tpu/native/__init__.py`` with the same API.
The reference's runtime is C++ (ECR core, controller, nodes, logging —
SURVEY.md §2.7); this package binds the framework's native equivalents:

- :class:`NativeIQStream` — mmap'd recorded-IQ reader with a slab ring and a
  background prefetch thread (the data loader feeding the card's host loop).
- :class:`BinLogWriter` / :class:`BinLogReader` — CRC-framed append-only
  binary record streams (the ``logs/bin`` role of the reference).
- :class:`MsgTransport` — framed TCP control-plane transport (the raw-struct
  TCP star of src/crts_controller.cpp, with explicit framing).
- :func:`msequence_bytes_native`, :func:`fill_packets`, :func:`bit_errors` —
  the packet engine / BER oracle hot path.

The library is compiled at first use from the repo's ``native/src/*.cpp``
with ``g++`` and the flags of ``native/Makefile`` into ``build/native/`` at
the root of the checkout, under a name keyed by a hash of the sources and
flags; N processes on a fresh checkout compile it once
(``utils/build.py``).  ``available()`` is False only when the build or the
load fails; every consumer then has a pure-Python path, except those that
ask for the native one by name.  Nothing compiles at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
from pathlib import Path

import numpy as np

from cognitive_radio_network_tpu_torch.utils.build import build_once

__all__ = [
    "available",
    "load",
    "library_path",
    "NativeIQStream",
    "BinLogWriter",
    "BinLogReader",
    "MsgTransport",
    "msequence_bytes_native",
    "fill_packets",
    "packet_number",
    "bit_errors",
    "crc32",
]

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread")  # native/Makefile:5
LDFLAGS = ("-shared", "-pthread")  # native/Makefile:6
_lib: ctypes.CDLL | None = None
_load_attempted = False


def _sources() -> list[Path]:
    return sorted((_NATIVE_DIR / "src").glob("*.cpp"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(CXXFLAGS + LDFLAGS).encode())
    for src in [*_sources(), *sorted((_NATIVE_DIR / "include").glob("*.h"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / f"libcrn_runtime_{h.hexdigest()[:16]}.so"


def _compile(tmp: Path) -> None:
    """One g++ call over ``native/src/*.cpp`` into ``tmp`` (the Makefile's
    rule, written here so nothing lands in the JAX package's directory)."""
    cmd = ["g++", *CXXFLAGS, "-I", str(_NATIVE_DIR / "include"), *map(str, _sources()),
           *LDFLAGS, "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed with code {proc.returncode}:\n{proc.stderr}")


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.crn_version.restype = ctypes.c_uint32

    lib.crn_iq_open.restype = ctypes.c_void_p
    lib.crn_iq_open.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.c_uint32,
        ctypes.c_uint64,
        ctypes.c_int,
    ]
    lib.crn_iq_next.restype = ctypes.c_int64
    lib.crn_iq_next.argtypes = [ctypes.c_void_p, f32p]
    lib.crn_iq_next_planar.restype = ctypes.c_int64
    lib.crn_iq_next_planar.argtypes = [ctypes.c_void_p, f32p, f32p]
    lib.crn_iq_cursor.restype = ctypes.c_uint64
    lib.crn_iq_cursor.argtypes = [ctypes.c_void_p]
    lib.crn_iq_num_samples.restype = ctypes.c_uint64
    lib.crn_iq_num_samples.argtypes = [ctypes.c_void_p]
    lib.crn_iq_close.argtypes = [ctypes.c_void_p]

    lib.crn_binlog_create.restype = ctypes.c_void_p
    lib.crn_binlog_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.crn_binlog_open.restype = ctypes.c_void_p
    lib.crn_binlog_open.argtypes = [ctypes.c_char_p]
    lib.crn_binlog_append.restype = ctypes.c_int
    lib.crn_binlog_append.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_uint32,
    ]
    lib.crn_binlog_flush.restype = ctypes.c_int
    lib.crn_binlog_flush.argtypes = [ctypes.c_void_p]
    lib.crn_binlog_num_records.restype = ctypes.c_uint64
    lib.crn_binlog_num_records.argtypes = [ctypes.c_void_p]
    lib.crn_binlog_record.restype = ctypes.c_int64
    lib.crn_binlog_record.argtypes = [
        ctypes.c_void_p,
        ctypes.c_uint64,
        ctypes.c_void_p,
        ctypes.c_uint64,
    ]
    lib.crn_binlog_stream_name.restype = ctypes.c_char_p
    lib.crn_binlog_stream_name.argtypes = [ctypes.c_void_p]
    lib.crn_binlog_close.argtypes = [ctypes.c_void_p]
    lib.crn_crc32.restype = ctypes.c_uint32
    lib.crn_crc32.argtypes = [ctypes.c_char_p, ctypes.c_uint64]

    lib.crn_tcp_listen.restype = ctypes.c_int
    lib.crn_tcp_listen.argtypes = [ctypes.c_uint16]
    lib.crn_tcp_accept.restype = ctypes.c_int
    lib.crn_tcp_accept.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.crn_tcp_connect.restype = ctypes.c_int
    lib.crn_tcp_connect.argtypes = [ctypes.c_char_p, ctypes.c_uint16, ctypes.c_int]
    lib.crn_msg_send.restype = ctypes.c_int
    lib.crn_msg_send.argtypes = [
        ctypes.c_int,
        ctypes.c_uint8,
        ctypes.c_char_p,
        ctypes.c_uint32,
    ]
    lib.crn_msg_send2.restype = ctypes.c_int
    lib.crn_msg_send2.argtypes = [
        ctypes.c_int,
        ctypes.c_uint8,
        ctypes.c_char_p,
        ctypes.c_uint32,
        ctypes.c_void_p,
        ctypes.c_uint32,
    ]
    lib.crn_msg_recv.restype = ctypes.c_int64
    lib.crn_msg_recv.argtypes = [
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_void_p,
        ctypes.c_uint64,
        ctypes.c_int,
    ]
    lib.crn_tcp_close.argtypes = [ctypes.c_int]

    lib.crn_msequence_bytes.argtypes = [
        ctypes.c_uint32,
        ctypes.c_uint32,
        ctypes.c_uint32,
        u8p,
        ctypes.c_uint64,
    ]
    lib.crn_fill_packets.argtypes = [
        u8p,
        ctypes.c_uint32,
        ctypes.c_uint32,
        ctypes.c_uint32,
        u8p,
    ]
    lib.crn_packet_number.restype = ctypes.c_uint32
    lib.crn_packet_number.argtypes = [u8p]
    lib.crn_bit_errors.restype = ctypes.c_uint64
    lib.crn_bit_errors.argtypes = [u8p, u8p, ctypes.c_uint64]


def load() -> ctypes.CDLL | None:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _load_attempted
    if _lib is not None:
        return _lib
    if _load_attempted:
        # Cache failure too: available() sits on per-LogSink / per-transport
        # paths, and a failed build must not be retried on every call.
        return None
    _load_attempted = True
    path = library_path()
    try:
        build_once(path, _compile)
        lib = ctypes.CDLL(str(path))
        _bind(lib)
    except (OSError, RuntimeError, subprocess.TimeoutExpired):
        return None
    _lib = lib
    return lib


def available() -> bool:
    return load() is not None


def _require() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError(
            "native runtime library unavailable: building native/src/*.cpp with g++ "
            "into build/native/ failed"
        )
    return lib


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class NativeIQStream:
    """Prefetching block reader over a recorded-IQ capture (f32 I/Q pairs)."""

    def __init__(
        self,
        path: str | Path,
        block_samples: int,
        *,
        depth: int = 8,
        start_sample: int = 0,
        loop: bool = False,
    ):
        self._lib = _require()
        self.block_samples = int(block_samples)
        self._h = self._lib.crn_iq_open(
            str(path).encode(), self.block_samples, depth, start_sample, int(loop)
        )
        if not self._h:
            raise FileNotFoundError(f"cannot open IQ capture {path}")

    @property
    def num_samples(self) -> int:
        return int(self._lib.crn_iq_num_samples(self._h))

    @property
    def cursor(self) -> int:
        """Sample index of the next block (resumable stream cursor)."""
        return int(self._lib.crn_iq_cursor(self._h))

    def next_block(self) -> np.ndarray | None:
        """Next (block_samples, 2) float32 planes block; None at end."""
        out = np.empty((self.block_samples, 2), np.float32)
        n = self._lib.crn_iq_next(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        )
        if n <= 0:
            return None
        return out

    def next_planar(self) -> tuple[np.ndarray, np.ndarray] | None:
        """Next block as a planar (xr, xi) pair — the framework's preferred
        device layout (signal/iq.py); de-interleaved on the prefetch thread."""
        f32p = ctypes.POINTER(ctypes.c_float)
        out_i = np.empty(self.block_samples, np.float32)
        out_q = np.empty(self.block_samples, np.float32)
        n = self._lib.crn_iq_next_planar(
            self._h, out_i.ctypes.data_as(f32p), out_q.ctypes.data_as(f32p)
        )
        if n <= 0:
            return None
        return out_i, out_q

    def blocks(self):
        while True:
            b = self.next_block()
            if b is None:
                return
            yield b

    def planar_blocks(self):
        while True:
            b = self.next_planar()
            if b is None:
                return
            yield b

    def close(self) -> None:
        if self._h:
            self._lib.crn_iq_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BinLogWriter:
    def __init__(self, path: str | Path, stream_name: str):
        self._lib = _require()
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        self._h = self._lib.crn_binlog_create(
            str(path).encode(), stream_name.encode()
        )
        if not self._h:
            raise OSError(f"cannot create binlog {path}")

    def append(self, payload: bytes) -> None:
        if self._lib.crn_binlog_append(self._h, payload, len(payload)) != 0:
            raise OSError("binlog append failed")

    def flush(self) -> None:
        self._lib.crn_binlog_flush(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.crn_binlog_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BinLogReader:
    def __init__(self, path: str | Path):
        self._lib = _require()
        self._h = self._lib.crn_binlog_open(str(path).encode())
        if not self._h:
            raise OSError(f"cannot open binlog {path}")
        self.stream_name = self._lib.crn_binlog_stream_name(self._h).decode()

    def __len__(self) -> int:
        return int(self._lib.crn_binlog_num_records(self._h))

    def record(self, idx: int) -> bytes:
        buf = ctypes.create_string_buffer(1 << 16)
        n = self._lib.crn_binlog_record(self._h, idx, buf, len(buf))
        if n == -2:
            raise OSError(f"binlog record {idx}: CRC mismatch")
        if n < 0:
            raise IndexError(idx)
        if n > len(buf):
            buf = ctypes.create_string_buffer(int(n))
            n = self._lib.crn_binlog_record(self._h, idx, buf, len(buf))
        return buf.raw[: int(n)]

    def __iter__(self):
        for i in range(len(self)):
            yield self.record(i)

    def close(self) -> None:
        if self._h:
            self._lib.crn_binlog_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MsgTransport:
    """Framed TCP messaging: [u32 len][u8 type][payload] (little-endian).

    Class methods create listening/connected endpoints; instances wrap a
    connected fd.  Wire-compatible with the pure-Python endpoint in
    runtime/netctl.py.
    """

    # Default receive capacity; grow with set_recv_cap() for scenarios whose
    # medium blocks exceed it (PyMsgTransport is unbounded — parity matters).
    DEFAULT_CAP = 1 << 22

    def __init__(self, fd: int):
        self._lib = _require()
        self.fd = fd
        self._cap = self.DEFAULT_CAP
        self._buf = None  # lazily allocated, reused across recvs

    def set_recv_cap(self, cap: int) -> None:
        if cap > self._cap:
            self._cap = int(cap)
            self._buf = None

    @staticmethod
    def listen(port: int) -> int:
        fd = _require().crn_tcp_listen(port)
        if fd < 0:
            raise OSError(f"cannot listen on port {port}")
        return fd

    @classmethod
    def accept(cls, server_fd: int, timeout_ms: int = -1) -> "MsgTransport | None":
        fd = _require().crn_tcp_accept(server_fd, timeout_ms)
        if fd == -2:
            return None  # timeout
        if fd < 0:
            raise OSError("accept failed")
        return cls(fd)

    @classmethod
    def connect(cls, host: str, port: int, timeout_ms: int = 5000) -> "MsgTransport":
        fd = _require().crn_tcp_connect(host.encode(), port, timeout_ms)
        if fd < 0:
            raise ConnectionError(f"cannot connect to {host}:{port}")
        return cls(fd)

    @staticmethod
    def close_server(server_fd: int) -> None:
        _require().crn_tcp_close(server_fd)

    def send(self, msg_type: int, payload: bytes = b"") -> None:
        if self._lib.crn_msg_send(self.fd, msg_type, payload, len(payload)) != 0:
            raise ConnectionError("send failed")

    def send2(self, msg_type: int, head: bytes, arr: np.ndarray) -> None:
        """One framed message with payload head||arr, gathered with writev —
        the ~0.5 MB medium-block buffer is never copied on this side."""
        arr = np.ascontiguousarray(arr)
        if (
            self._lib.crn_msg_send2(
                self.fd,
                msg_type,
                head,
                len(head),
                arr.ctypes.data_as(ctypes.c_void_p),
                arr.nbytes,
            )
            != 0
        ):
            raise ConnectionError("send failed")

    def recv(self, timeout_ms: int = -1) -> tuple[int, bytes] | None:
        """One message as (type, payload); None on timeout; raises on close."""
        if self._buf is None:
            self._buf = ctypes.create_string_buffer(self._cap)
        buf = self._buf
        t = ctypes.c_uint8(0)
        n = self._lib.crn_msg_recv(
            self.fd, ctypes.byref(t), buf, self._cap, timeout_ms
        )
        if n == -2:
            return None
        if n == -3:
            raise ConnectionResetError("peer closed")
        if n == -4:
            # crn_msg_recv drained the oversized payload, so the stream stays
            # framed — surface a clear, recoverable error.
            raise ValueError(
                f"message payload exceeds recv cap {self._cap}; call "
                "set_recv_cap() or use transport='python'"
            )
        if n < 0:
            raise ConnectionError(f"recv failed ({n})")
        # string_at copies exactly n bytes — buf.raw[:n] first copied the
        # ENTIRE capacity buffer (~4 MB with medium-block caps) on every
        # message, ~8 ms of pure memcpy per lockstep step per node
        return int(t.value), ctypes.string_at(buf, int(n))

    def close(self) -> None:
        if self.fd >= 0:
            self._lib.crn_tcp_close(self.fd)
            self.fd = -1


def msequence_bytes_native(
    n: int, m: int = 12, genpoly: int | None = None, init: int = 1
) -> np.ndarray:
    from cognitive_radio_network_tpu_torch.signal.msequence import DEFAULT_GENPOLY

    lib = _require()
    if genpoly is None:
        genpoly = DEFAULT_GENPOLY[m]
    out = np.empty(n, np.uint8)
    lib.crn_msequence_bytes(m, genpoly, init, _u8(out), n)
    return out


def fill_packets(
    num_packets: int, packet_len: int, first_num: int, payload_template: np.ndarray
) -> np.ndarray:
    lib = _require()
    tpl = np.ascontiguousarray(payload_template, np.uint8)
    assert tpl.size == packet_len
    out = np.empty((num_packets, packet_len), np.uint8)
    lib.crn_fill_packets(_u8(out), num_packets, packet_len, first_num, _u8(tpl))
    return out


def packet_number(packet: np.ndarray) -> int:
    return int(_require().crn_packet_number(_u8(np.ascontiguousarray(packet, np.uint8))))


def bit_errors(a: np.ndarray, b: np.ndarray) -> int:
    lib = _require()
    aa = np.ascontiguousarray(a, np.uint8)
    bb = np.ascontiguousarray(b, np.uint8)
    assert aa.size == bb.size
    return int(lib.crn_bit_errors(_u8(aa), _u8(bb), aa.size))


def crc32(data: bytes) -> int:
    return int(_require().crn_crc32(data, len(data)))
