"""Forward error correction: none / rep3 / Hamming(7,4) / Hamming(12,8) / conv K=7 r=1/2.

Port of ``cognitive_radio_network_tpu/phy/fec.py``.  Equivalent of the
liquid-dsp ``fec_scheme`` set the reference uses: LIQUID_FEC_HAMMING128
(default inner code, src/extensible_cognitive_radio.cpp:102),
LIQUID_FEC_HAMMING74 (interferer GMSK frames, src/interferer.cpp:164), and
LIQUID_FEC_CONV_V27 (predictive scenario SU link,
scenarios/predictive_model.cfg:81-82).

The byte-level host API (encode expands, decode corrects and contracts) and
its tables are the reference's numpy code, copied.  :func:`decode_bits` is
the batched decode of the rx path on the device: table codes are one gather
each, and v27 is :func:`viterbi_decode`: on a card one kernel launch, on the
CPU a loop over time with all 64 states add-compare-selected at once, then a
traceback loop (both in ``ops/viterbi.py``, with the code's trellis).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.ops.viterbi import (
    _CONV_K,
    _conv_inverse,
    _conv_tables,
    frames_at_one_stride,
    viterbi_decode_k7,
    viterbi_decode_plain,
)
from cognitive_radio_network_tpu_torch.phy.bits import pack_bits, pack_bits_tensor, unpack_bits
from cognitive_radio_network_tpu_torch.utils.device import on_cuda

__all__ = [
    "SCHEMES",
    "encoded_length",
    "encode",
    "encode_batch",
    "decode",
    "decode_bits",
    "conv_encode_bits",
    "conv_encode_bits_batch",
    "viterbi_decode_bits",
    "viterbi_decode",
]

SCHEMES = ("none", "rep3", "h74", "h128", "v27")

# --- Hamming(7,4) ----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _h74_tables():
    # Generator: codeword = [p1 p2 d3 p4 d2 d1 d0] (positions 1..7, parity at
    # powers of two). Encode/decode via lookup tables.
    enc = np.zeros(16, np.uint8)
    for d in range(16):
        d3, d2, d1, d0 = (d >> 3) & 1, (d >> 2) & 1, (d >> 1) & 1, d & 1
        p1 = d3 ^ d2 ^ d0
        p2 = d3 ^ d1 ^ d0
        p4 = d2 ^ d1 ^ d0
        cw = (p1 << 6) | (p2 << 5) | (d3 << 4) | (p4 << 3) | (d2 << 2) | (d1 << 1) | d0
        enc[d] = cw
    dec = np.zeros(128, np.uint8)
    for cw in range(128):
        bits = [(cw >> (6 - i)) & 1 for i in range(7)]  # positions 1..7
        s1 = bits[0] ^ bits[2] ^ bits[4] ^ bits[6]
        s2 = bits[1] ^ bits[2] ^ bits[5] ^ bits[6]
        s4 = bits[3] ^ bits[4] ^ bits[5] ^ bits[6]
        syndrome = s1 | (s2 << 1) | (s4 << 2)
        fixed = list(bits)
        if syndrome:
            fixed[syndrome - 1] ^= 1
        d = (fixed[2] << 3) | (fixed[4] << 2) | (fixed[5] << 1) | fixed[6]
        dec[cw] = d
    return enc, dec


# --- Hamming(12,8): shortened Hamming(15,11) -------------------------------


@functools.lru_cache(maxsize=None)
def _h128_matrices():
    # Parity-check H for Hamming(15,11): columns are 1..15 in binary; shorten
    # the three highest data positions to get (12,8). Codeword layout: 12 bits,
    # position p (1-indexed) is a parity bit if p is a power of two.
    positions = list(range(1, 13))
    parity_pos = [1, 2, 4, 8]
    data_pos = [p for p in positions if p not in parity_pos]  # 8 positions
    enc = np.zeros(256, np.uint16)
    for d in range(256):
        bits = {p: 0 for p in positions}
        for i, p in enumerate(data_pos):
            bits[p] = (d >> (7 - i)) & 1
        for pp in parity_pos:
            s = 0
            for p in positions:
                if p != pp and (p & pp):
                    s ^= bits[p]
            bits[pp] = s
        cw = 0
        for p in positions:
            cw = (cw << 1) | bits[p]
        enc[d] = cw
    return enc, tuple(parity_pos), tuple(data_pos)


@functools.lru_cache(maxsize=None)
def _h128_decode_table():
    enc, parity_pos, data_pos = _h128_matrices()
    dec = np.zeros(4096, np.uint8)
    # Build syndrome: for received word r, syndrome = XOR of position indices
    # of set bits (classic Hamming); a nonzero syndrome <= 12 flips that bit.
    for r in range(4096):
        bits = [(r >> (12 - p)) & 1 for p in range(1, 13)]
        syn = 0
        for p in range(1, 13):
            if bits[p - 1]:
                syn ^= p
        fixed = list(bits)
        if 1 <= syn <= 12:
            fixed[syn - 1] ^= 1
        d = 0
        for p in data_pos:
            d = (d << 1) | fixed[p - 1]
        dec[r] = d
    return dec


# --- Convolutional K=7, rate 1/2: the trellis lives in ops/viterbi.py --------


def conv_encode_bits(bits: np.ndarray) -> np.ndarray:
    """Encode with K-1 zero tail flush; returns 2*(n+6) bits."""
    ns, out = _conv_tables()
    state = 0
    res = []
    for b in list(np.asarray(bits, np.uint8)) + [0] * (_CONV_K - 1):
        o = out[state, b]
        res.extend([(o >> 1) & 1, o & 1])
        state = ns[state, b]
    return np.array(res, np.uint8)


def conv_encode_bits_batch(bits: np.ndarray) -> np.ndarray:
    """Batched K=7 R=1/2 convolutional encode: bits (B, N) -> (B, 2*(N+6)).

    Sequential in bit position, vectorized over the batch axis."""
    ns, out = _conv_tables()
    bits = np.asarray(bits, np.uint8)
    b, n = bits.shape
    full = np.concatenate(
        [bits, np.zeros((b, _CONV_K - 1), np.uint8)], axis=1
    )
    res = np.empty((b, 2 * (n + _CONV_K - 1)), np.uint8)
    state = np.zeros(b, np.int64)
    for i in range(full.shape[1]):
        o = out[state, full[:, i]]
        res[:, 2 * i] = (o >> 1) & 1
        res[:, 2 * i + 1] = o & 1
        state = ns[state, full[:, i]]
    return res


def _pad_bits_batch(bits: np.ndarray) -> np.ndarray:
    rem = (-bits.shape[-1]) % 8
    if rem:
        bits = np.concatenate(
            [bits, np.zeros((*bits.shape[:-1], rem), np.uint8)], axis=-1
        )
    return bits


def encode_batch(scheme: str, data: np.ndarray) -> np.ndarray:
    """Batched encode: data (B, N) uint8 -> (B, encoded_length(scheme, N)).

    Bit-identical to per-frame :func:`encode`; vectorized over frames."""
    data = np.asarray(data, np.uint8)
    if data.ndim != 2:
        raise ValueError(f"expected (B, N), got {data.shape}")
    b, n = data.shape
    if scheme == "none":
        return data.copy()
    if scheme == "rep3":
        return np.tile(data, (1, 3))
    if scheme == "h74":
        enc, _ = _h74_tables()
        hi, lo = data >> 4, data & 0xF
        cws = np.empty((b, 2 * n), np.uint8)
        cws[:, 0::2], cws[:, 1::2] = enc[hi], enc[lo]
        bits = ((cws[..., None] >> np.arange(6, -1, -1)) & 1).reshape(b, -1)
        return np.packbits(_pad_bits_batch(bits), axis=-1)
    if scheme == "h128":
        enc, _, _ = _h128_matrices()
        cws = enc[data]
        bits = (
            ((cws[..., None] >> np.arange(11, -1, -1)) & 1)
            .astype(np.uint8)
            .reshape(b, -1)
        )
        return np.packbits(_pad_bits_batch(bits), axis=-1)
    if scheme == "v27":
        bits = np.unpackbits(data, axis=-1)
        return np.packbits(
            _pad_bits_batch(conv_encode_bits_batch(bits)), axis=-1
        )
    raise ValueError(f"unknown fec scheme: {scheme}")


def viterbi_decode_bits(coded: np.ndarray, n_bits: int) -> np.ndarray:
    """Hard-decision Viterbi over 64 states; numpy vectorized over states."""
    coded = np.asarray(coded, np.uint8)
    t_total = n_bits + _CONV_K - 1
    pm = np.full(64, 1 << 20, np.int32)
    pm[0] = 0
    bp = np.zeros((t_total, 64), np.int8)  # input bit chosen into each state
    prev = np.zeros((t_total, 64), np.int8)  # predecessor index selector
    inv_s, inv_b, inv_o = _conv_inverse()

    for t in range(t_total):
        r = (int(coded[2 * t]) << 1) | int(coded[2 * t + 1])
        # branch metric = hamming distance of 2-bit symbols
        bm = np.array(
            [[bin(r ^ int(o)).count("1") for o in row] for row in inv_o], np.int32
        )
        cand = pm[inv_s] + bm  # (64, 2)
        sel = np.argmin(cand, axis=1)
        pm = cand[np.arange(64), sel]
        bp[t] = inv_b[np.arange(64), sel]
        prev[t] = sel

    # Traceback from state 0 (tail-flushed).
    state = 0
    bits_rev = []
    for t in range(t_total - 1, -1, -1):
        sel = prev[t, state]
        bits_rev.append(int(bp[t, state]))
        state = int(inv_s[state, sel])
    bits = np.array(bits_rev[::-1], np.uint8)
    return bits[:n_bits]


def viterbi_decode(coded_bits: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Batched hard-decision Viterbi: coded bits (..., 2*(n_bits+6)) -> bits
    uint8 (..., n_bits), on the device of the input.

    A CUDA tensor takes the kernel, one launch per call
    (:func:`~cognitive_radio_network_tpu_torch.ops.viterbi.viterbi_decode_k7`):
    coded bits of another integer dtype are cast to uint8 first, as
    :func:`decode_bits` does, and frames the kernel cannot read in place are
    copied on the card.  A CPU tensor takes the plain loop
    (:func:`~cognitive_radio_network_tpu_torch.ops.viterbi.viterbi_decode_plain`).
    Both give the same bits: a tie keeps the first predecessor, and the
    traceback starts from state 0 (the tail flush)."""
    if on_cuda(coded_bits):
        coded_bits = coded_bits.to(torch.uint8)
        if not frames_at_one_stride(coded_bits):
            coded_bits = coded_bits.contiguous()
        return viterbi_decode_k7(coded_bits, n_bits)
    return viterbi_decode_plain(coded_bits, n_bits)


def decode_bits(scheme: str, bits: torch.Tensor, n_dec: int) -> torch.Tensor:
    """Batched decode: coded BITS (..., n_bits) -> bytes uint8 (..., n_dec).

    Bit-identical to the host :func:`decode` (which takes packed bytes); the
    rx path's FEC on the device."""
    bits = bits.to(torch.uint8)
    lead = bits.shape[:-1]
    dev = bits.device
    if scheme == "none":
        return pack_bits_tensor(bits[..., : n_dec * 8])
    if scheme == "rep3":
        a = pack_bits_tensor(bits[..., : 24 * n_dec])
        x, y, z = a[..., :n_dec], a[..., n_dec : 2 * n_dec], a[..., 2 * n_dec : 3 * n_dec]
        return (x & y) | (x & z) | (y & z)
    if scheme == "h74":
        dec = _device_table("h74", dev)
        cw = bits[..., : n_dec * 14].reshape(*lead, 2 * n_dec, 7).to(torch.int64)
        pow2 = 1 << torch.arange(6, -1, -1, dtype=torch.int64, device=dev)
        vals = dec[(cw * pow2).sum(dim=-1)]
        return (vals[..., 0::2] << 4) | vals[..., 1::2]
    if scheme == "h128":
        dec = _device_table("h128", dev)
        cw = bits[..., : n_dec * 12].reshape(*lead, n_dec, 12).to(torch.int64)
        pow2 = 1 << torch.arange(11, -1, -1, dtype=torch.int64, device=dev)
        return dec[(cw * pow2).sum(dim=-1)]
    if scheme == "v27":
        return pack_bits_tensor(viterbi_decode(bits, 8 * n_dec))
    raise ValueError(f"unknown fec scheme: {scheme}")


@functools.lru_cache(maxsize=16)
def _device_table(scheme: str, device: torch.device) -> torch.Tensor:
    table = _h74_tables()[1] if scheme == "h74" else _h128_decode_table()
    return torch.from_numpy(table).to(device)


# --- byte-level registry ----------------------------------------------------


def encoded_length(scheme: str, n_dec: int) -> int:
    """Encoded payload length in bytes for ``n_dec`` decoded bytes."""
    if scheme == "none":
        return n_dec
    if scheme == "rep3":
        return 3 * n_dec
    if scheme == "h74":
        return (n_dec * 2 * 7 + 7) // 8  # two nibbles -> 7 bits each
    if scheme == "h128":
        return (n_dec * 12 + 7) // 8
    if scheme == "v27":
        return (2 * (8 * n_dec + _CONV_K - 1) + 7) // 8
    raise ValueError(f"unknown fec scheme: {scheme}")


def encode(scheme: str, data: np.ndarray) -> np.ndarray:
    data = np.asarray(data, np.uint8)
    if scheme == "none":
        return data.copy()
    if scheme == "rep3":
        return np.tile(data, 3)
    if scheme == "h74":
        enc, _ = _h74_tables()
        hi, lo = data >> 4, data & 0xF
        cws = np.empty(2 * len(data), np.uint8)
        cws[0::2], cws[1::2] = enc[hi], enc[lo]
        bits = ((cws[:, None] >> np.arange(6, -1, -1)) & 1).reshape(-1)
        return pack_bits(_pad_bits(bits))
    if scheme == "h128":
        enc, _, _ = _h128_matrices()
        cws = enc[data]
        bits = ((cws[:, None] >> np.arange(11, -1, -1)) & 1).astype(np.uint8).reshape(-1)
        return pack_bits(_pad_bits(bits))
    if scheme == "v27":
        bits = unpack_bits(data)
        return pack_bits(_pad_bits(conv_encode_bits(bits)))
    raise ValueError(f"unknown fec scheme: {scheme}")


def decode(scheme: str, coded: np.ndarray, n_dec: int) -> np.ndarray:
    coded = np.asarray(coded, np.uint8)
    if scheme == "none":
        return coded[:n_dec].copy()
    if scheme == "rep3":
        a = coded[:n_dec].astype(np.uint16)
        b = coded[n_dec : 2 * n_dec].astype(np.uint16)
        c = coded[2 * n_dec : 3 * n_dec].astype(np.uint16)
        return ((a & b) | (a & c) | (b & c)).astype(np.uint8)  # bitwise majority
    if scheme == "h74":
        _, dec = _h74_tables()
        bits = unpack_bits(coded)[: n_dec * 14]
        cws = bits.reshape(-1, 7)
        vals = dec[np.dot(cws, 1 << np.arange(6, -1, -1))]
        return ((vals[0::2] << 4) | vals[1::2]).astype(np.uint8)
    if scheme == "h128":
        dec = _h128_decode_table()
        bits = unpack_bits(coded)[: n_dec * 12]
        cws = bits.reshape(-1, 12)
        return dec[np.dot(cws, 1 << np.arange(11, -1, -1))].astype(np.uint8)
    if scheme == "v27":
        bits = unpack_bits(coded)
        return pack_bits(viterbi_decode_bits(bits, 8 * n_dec))
    raise ValueError(f"unknown fec scheme: {scheme}")


def _pad_bits(bits: np.ndarray) -> np.ndarray:
    rem = (-len(bits)) % 8
    if rem:
        bits = np.concatenate([bits, np.zeros(rem, np.uint8)])
    return bits
