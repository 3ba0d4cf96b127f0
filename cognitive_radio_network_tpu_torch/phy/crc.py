"""Data-validity checks: CRC-32, CRC-16, 8-bit checksum.

Port of ``cognitive_radio_network_tpu/phy/crc.py``.  Equivalent of
liquid-dsp's ``crc_scheme`` family used by the reference's frame properties
(LIQUID_CRC_32 default, src/extensible_cognitive_radio.cpp:101).  Standard
polynomials (CRC-32/IEEE reflected 0xEDB88320, CRC-16/IBM reflected 0xA001).

The host generators are the reference's numpy code, copied.  The tensor forms
validate many decoded frames on the device:

* :func:`crc32_tensor` / :func:`crc16_tensor`: byte-serial table scans,
  computed in int64 with masks (uint32 bitwise support on the card is
  partial);
* :func:`crc_check`: the GF(2) affine form, one float32 matmul of 0/1 values
  (exact: every sum is at most 8N, far below 2**24) reduced mod 2, in full
  float32 (TF32 off).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.phy.bits import pack_bits_tensor, unpack_bits_tensor
from cognitive_radio_network_tpu_torch.utils.device import full_f32

__all__ = [
    "crc_generate",
    "crc_generate_batch",
    "crc_validate",
    "crc_sizes",
    "SCHEMES",
    "crc32_tensor",
    "crc16_tensor",
    "crc_check",
]

SCHEMES = ("none", "checksum", "crc16", "crc32")


@functools.lru_cache(maxsize=None)
def _crc32_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = np.uint32(i)
        for _ in range(8):
            c = np.uint32((c >> 1) ^ (0xEDB88320 if (c & 1) else 0))
        table[i] = c
    return table


@functools.lru_cache(maxsize=None)
def _crc16_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint16)
    for i in range(256):
        c = np.uint16(i)
        for _ in range(8):
            c = np.uint16((c >> 1) ^ (0xA001 if (c & 1) else 0))
        table[i] = c
    return table


def crc_sizes(scheme: str) -> int:
    """Appended check length in bytes."""
    return {"none": 0, "checksum": 1, "crc16": 2, "crc32": 4}[scheme]


def _crc32(data: np.ndarray) -> int:
    t = _crc32_table()
    c = np.uint32(0xFFFFFFFF)
    for b in np.asarray(data, np.uint8):
        c = np.uint32(t[(c ^ b) & 0xFF] ^ (c >> 8))
    return int(c ^ np.uint32(0xFFFFFFFF))


def _crc16(data: np.ndarray) -> int:
    t = _crc16_table()
    c = np.uint16(0xFFFF)
    for b in np.asarray(data, np.uint8):
        c = np.uint16(t[(c ^ b) & 0xFF] ^ (c >> 8))
    return int(c)


def _checksum(data: np.ndarray) -> int:
    return int(np.sum(np.asarray(data, np.uint64)) & 0xFF)


def crc_generate(scheme: str, data: np.ndarray) -> np.ndarray:
    """Check bytes (big-endian) to append for ``data``."""
    if scheme == "none":
        return np.zeros(0, np.uint8)
    if scheme == "checksum":
        return np.array([_checksum(data)], np.uint8)
    if scheme == "crc16":
        v = _crc16(data)
        return np.array([(v >> 8) & 0xFF, v & 0xFF], np.uint8)
    if scheme == "crc32":
        v = _crc32(data)
        return np.array([(v >> s) & 0xFF for s in (24, 16, 8, 0)], np.uint8)
    raise ValueError(f"unknown crc scheme: {scheme}")


def crc_generate_batch(scheme: str, data: np.ndarray) -> np.ndarray:
    """Batched check bytes: data (B, N) -> (B, crc_sizes(scheme)).

    Bit-identical to per-frame :func:`crc_generate`; crc16/crc32 go through
    the GF(2) affine matrix (:func:`_crc_matrix`) as one float32 matmul."""
    data = np.asarray(data, np.uint8)
    b, n = data.shape
    if scheme == "none":
        return np.zeros((b, 0), np.uint8)
    if scheme == "checksum":
        return (np.sum(data.astype(np.uint64), axis=1) & 0xFF).astype(
            np.uint8
        )[:, None]
    cols, c0 = _crc_matrix(scheme, n)
    bits = np.unpackbits(data, axis=1).astype(np.float32)
    acc = bits @ cols.astype(np.float32)  # exact: sums <= 8N << 2**24
    comp = (acc.astype(np.int32) & 1).astype(np.uint8) ^ c0
    return np.packbits(comp, axis=1)


def _crc_batch_scan(scheme: str, data: np.ndarray) -> np.ndarray:
    """Byte-serial table recursion, vectorized over frames: the ground truth
    the GF(2) matrix is built from."""
    data = np.asarray(data, np.uint8)
    b, n = data.shape
    if scheme == "crc16":
        t = _crc16_table()
        c = np.full(b, 0xFFFF, np.uint16)
        for i in range(n):
            c = (t[(c ^ data[:, i]) & 0xFF] ^ (c >> 8)).astype(np.uint16)
        return np.stack([(c >> 8) & 0xFF, c & 0xFF], axis=1).astype(np.uint8)
    if scheme == "crc32":
        t = _crc32_table()
        c = np.full(b, 0xFFFFFFFF, np.uint32)
        for i in range(n):
            c = (t[(c ^ data[:, i]) & 0xFF] ^ (c >> 8)).astype(np.uint32)
        c = c ^ np.uint32(0xFFFFFFFF)
        return np.stack(
            [(c >> s) & 0xFF for s in (24, 16, 8, 0)], axis=1
        ).astype(np.uint8)
    raise ValueError(f"unknown crc scheme: {scheme}")


def crc_validate(scheme: str, data_with_check: np.ndarray) -> bool:
    n = crc_sizes(scheme)
    if n == 0:
        return True
    data, chk = data_with_check[:-n], data_with_check[-n:]
    return bool(np.array_equal(crc_generate(scheme, data), chk))


def _table_scan(data: torch.Tensor, table: np.ndarray, init: int, mask: int) -> torch.Tensor:
    t = torch.from_numpy(table.astype(np.int64)).to(data.device)
    flat = data.reshape(-1, data.shape[-1]).to(torch.int64)
    c = torch.full((flat.shape[0],), init, dtype=torch.int64, device=data.device)
    for i in range(flat.shape[1]):
        c = (t[(c ^ flat[:, i]) & 0xFF] ^ (c >> 8)) & mask
    return c.reshape(data.shape[:-1])


def crc32_tensor(data_bytes: torch.Tensor) -> torch.Tensor:
    """Batched CRC-32 over the last axis of uint8 (..., L) -> int64 (...)
    holding the unsigned 32-bit value."""
    return _table_scan(data_bytes, _crc32_table(), 0xFFFFFFFF, 0xFFFFFFFF) ^ 0xFFFFFFFF


def crc16_tensor(data_bytes: torch.Tensor) -> torch.Tensor:
    """Batched CRC-16/IBM over the last axis of uint8 (..., L) -> int64 (...)."""
    return _table_scan(data_bytes, _crc16_table(), 0xFFFF, 0xFFFF)


@functools.lru_cache(maxsize=None)
def _crc_matrix(scheme: str, n_bytes: int) -> tuple[np.ndarray, np.ndarray]:
    """GF(2) form of the CRC: crc_bits(x) = (M^T x_bits) mod 2 XOR c0.

    CRCs are affine over GF(2), so column j of M is crc(e_j) ^ crc(0),
    computed once per (scheme, message length) with the batched host CRC."""
    zero = np.zeros((1, n_bytes), np.uint8)
    c0 = np.unpackbits(_crc_batch_scan(scheme, zero)[0])
    nb = n_bytes * 8
    msgs = np.zeros((nb, n_bytes), np.uint8)
    idx = np.arange(nb)
    msgs[idx, idx // 8] = (0x80 >> (idx % 8)).astype(np.uint8)
    cols = np.unpackbits(_crc_batch_scan(scheme, msgs), axis=1) ^ c0
    return cols.astype(np.int8), c0.astype(np.uint8)


@functools.lru_cache(maxsize=64)
def _device_crc_matrix(scheme: str, n_bytes: int, device: torch.device):
    cols, c0 = _crc_matrix(scheme, n_bytes)
    return (
        torch.from_numpy(cols.astype(np.float32)).to(device),
        torch.from_numpy(c0).to(device),
    )


def crc_check(scheme: str, data_with_check: torch.Tensor) -> torch.Tensor:
    """Batched validity check: uint8 (..., N + crc_sizes) -> bool (...).

    Same contract as :func:`crc_validate`, vectorized over leading axes so
    many frames validate in one pass on the device."""
    k = crc_sizes(scheme)
    dwc = data_with_check.to(torch.uint8)
    if k == 0:
        return torch.ones(dwc.shape[:-1], dtype=torch.bool, device=dwc.device)
    data, chk = dwc[..., :-k], dwc[..., -k:]
    if scheme == "checksum":
        comp = (data.to(torch.int64).sum(dim=-1) & 0xFF)[..., None].to(torch.uint8)
    else:
        cols, c0 = _device_crc_matrix(scheme, data.shape[-1], dwc.device)
        bits = unpack_bits_tensor(data).float()
        with full_f32():
            acc = bits @ cols
        comp = pack_bits_tensor((acc.to(torch.int32) & 1).to(torch.uint8) ^ c0)
    return (comp == chk).all(dim=-1)
