"""Plain OFDM link reference: a frozen NumPy frame generator and the soft
values of a frame received at its known start.

The generator restates the port's transmit side (``phy/framegen.py``,
``phy/fec.py`` encoders, ``phy/crc.py``, ``phy/modem.py``,
``phy/subcarriers.py``, ``signal/msequence.py``) for the schemes the
benchmark's configurations use, so the benchmark makes its frames without the
program.  Frame layout, for M subcarriers and cyclic prefix C:

    [ S0 | S0 | S1 with CP | header symbols | payload symbols ]

The header carries 8 user bytes, a 6-byte PHY header [payload_len:2 LE | mod
| fec0 | fec1 | crc] and a CRC-32, Hamming(12,8) coded, BPSK.  The payload
carries its bytes and CRC, coded by fec0 then fec1, at the configured
modulation.  Pilots are a BPSK PRBS per (symbol, pilot).

:func:`soft_values` works out what a receiver reports of a frame (its CFO
estimate, RSSI and EVM) from the received samples at the frame's true start,
with the arithmetic of the port's receiver (``phy/framesync.py``) restated as
plain tensor operations in a dtype of the caller's choice: float64 for the
reference, bfloat16 for the lower-precision control.  Nothing here imports
the program.
"""

from __future__ import annotations

import functools
import zlib

import numpy as np
import torch

MOD_SCHEMES = ("bpsk", "qpsk", "qam4", "psk8", "qam16", "qam64", "qam256")
FEC_SCHEMES = ("none", "rep3", "h74", "h128", "v27")
CRC_SCHEMES = ("none", "checksum", "crc16", "crc32")
BPS = {"bpsk": 1, "qpsk": 2, "qam4": 2, "qam16": 4, "qam64": 6}
HEADER_BYTES = 8
PHY_HEADER_BYTES = 6
CRC_BYTES = {"none": 0, "crc32": 4}
SC_NULL, SC_PILOT, SC_DATA = 0, 1, 2
CONV_K = 7
CONV_POLYS = (0o171, 0o133)


# ---------------------------------------------------------------- tables


def default_alloc(m: int) -> np.ndarray:
    """DC null, guard max(2, m/10) below Nyquist, pilots every 8 (4 for
    small m) offset by half the spacing; unshifted indices."""
    g = max(2, m // 10)
    p = 8 if m > 34 else 4
    alloc = np.full(m, SC_NULL, np.uint8)
    for i in range(1, m // 2 - g):
        t = SC_PILOT if (i + p // 2) % p == 0 else SC_DATA
        alloc[i] = t
        alloc[m - i] = t
    return alloc


def _prbs_bits(n: int, seed: int, m: int = 11, genpoly: int = 0x402) -> np.ndarray:
    """n output bits of the degree-11 Fibonacci LFSR (MSB out, parity feedback)."""
    mask = (1 << m) - 1
    state = seed & mask
    out = np.empty(n, np.int8)
    for i in range(n):
        out[i] = (state >> (m - 1)) & 1
        fb = bin(state & genpoly).count("1") & 1
        state = ((state << 1) | fb) & mask
    return out


def _prbs_qpsk(n: int, seed: int) -> np.ndarray:
    bits = _prbs_bits(2 * n, seed).astype(np.float64) * 2 - 1
    return (bits[:n] + 1j * bits[n:]) / np.sqrt(2)


@functools.lru_cache(maxsize=None)
def constellation(scheme: str) -> np.ndarray:
    """Gray-coded unit-energy points indexed by symbol value (complex128)."""
    bps = BPS[scheme]
    if scheme == "bpsk":
        return np.array([1.0 + 0j, -1.0 + 0j])
    if scheme in ("qpsk", "qam4"):
        return np.array([1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j]) / np.sqrt(2)
    half = bps // 2
    levels = 1 << half
    pam = 2 * np.arange(levels) - (levels - 1)
    level_of = np.zeros(levels)
    for p in range(levels):
        level_of[p ^ (p >> 1)] = pam[p]
    pts = np.array([level_of[s >> half] + 1j * level_of[s & (levels - 1)] for s in range(1 << bps)])
    return pts / np.sqrt(np.mean(np.abs(pts) ** 2))


@functools.lru_cache(maxsize=None)
def _h128_encode_table() -> np.ndarray:
    parity = (1, 2, 4, 8)
    data_pos = [p for p in range(1, 13) if p not in parity]
    enc = np.zeros(256, np.uint16)
    for d in range(256):
        bits = {p: 0 for p in range(1, 13)}
        for i, p in enumerate(data_pos):
            bits[p] = (d >> (7 - i)) & 1
        for pp in parity:
            bits[pp] = sum(bits[p] for p in range(1, 13) if p != pp and p & pp) & 1
        cw = 0
        for p in range(1, 13):
            cw = (cw << 1) | bits[p]
        enc[d] = cw
    return enc


@functools.lru_cache(maxsize=None)
def _conv_tables() -> tuple[np.ndarray, np.ndarray]:
    ns = np.zeros((64, 2), np.int64)
    out = np.zeros((64, 2), np.int64)
    for s in range(64):
        for b in range(2):
            reg = (b << 6) | s
            o = 0
            for g in CONV_POLYS:
                o = (o << 1) | (bin(reg & g).count("1") & 1)
            ns[s, b] = reg >> 1
            out[s, b] = o
    return ns, out


# ---------------------------------------------------------------- coding


def encoded_length(scheme: str, n: int) -> int:
    return {"none": n, "h128": (n * 12 + 7) // 8, "v27": (2 * (8 * n + CONV_K - 1) + 7) // 8}[scheme]


def _packbits_padded(bits: np.ndarray) -> np.ndarray:
    pad = (-bits.shape[1]) % 8
    if pad:
        bits = np.concatenate([bits, np.zeros((bits.shape[0], pad), np.uint8)], axis=1)
    return np.packbits(bits, axis=1)


def fec_encode(scheme: str, data: np.ndarray) -> np.ndarray:
    """(B, N) bytes -> (B, encoded_length(scheme, N)) bytes."""
    data = np.asarray(data, np.uint8)
    if scheme == "none":
        return data.copy()
    if scheme == "h128":
        cws = _h128_encode_table()[data]
        bits = ((cws[..., None] >> np.arange(11, -1, -1)) & 1).astype(np.uint8)
        return _packbits_padded(bits.reshape(data.shape[0], -1))
    if scheme == "v27":
        ns, out = _conv_tables()
        bits = np.concatenate([np.unpackbits(data, axis=1),
                               np.zeros((data.shape[0], CONV_K - 1), np.uint8)], axis=1)
        coded = np.empty((data.shape[0], 2 * bits.shape[1]), np.uint8)
        state = np.zeros(data.shape[0], np.int64)
        for i in range(bits.shape[1]):
            o = out[state, bits[:, i]]
            coded[:, 2 * i] = (o >> 1) & 1
            coded[:, 2 * i + 1] = o & 1
            state = ns[state, bits[:, i]]
        return _packbits_padded(coded)
    raise ValueError(f"fec scheme {scheme!r} is not in the benchmark's reference")


def crc_bytes(scheme: str, data: np.ndarray) -> np.ndarray:
    """Check bytes per row, big-endian (CRC-32 is zlib's polynomial and framing)."""
    data = np.asarray(data, np.uint8)
    if scheme == "none":
        return np.zeros((data.shape[0], 0), np.uint8)
    if scheme == "crc32":
        vals = np.array([zlib.crc32(row.tobytes()) for row in data], np.uint32)
        return np.stack([(vals >> s) & 0xFF for s in (24, 16, 8, 0)], axis=1).astype(np.uint8)
    raise ValueError(f"crc scheme {scheme!r} is not in the benchmark's reference")


# ---------------------------------------------------------------- frames


class FrameLayout:
    """Sizes, preambles and pilots of one PHY at one payload length."""

    HEADER_MOD, HEADER_FEC, HEADER_CRC = "bpsk", "h128", "crc32"

    def __init__(self, phy: dict, payload_len: int):
        self.phy = phy
        self.m = m = int(phy["num_subcarriers"])
        self.cp = int(phy["cp_len"])
        self.taper = int(phy["taper_len"])
        self.mod, self.fec0, self.fec1, self.crc = phy["mod"], phy["fec0"], phy["fec1"], phy["crc"]
        self.payload_len = payload_len
        alloc = default_alloc(m)
        self.data_idx = np.flatnonzero(alloc == SC_DATA)
        self.pilot_idx = np.flatnonzero(alloc == SC_PILOT)
        self.active_idx = np.flatnonzero(alloc != SC_NULL)
        nd = len(self.data_idx)
        s0 = np.zeros(m, np.complex128)
        even = self.active_idx[self.active_idx % 2 == 0]
        s0[even] = _prbs_qpsk(len(even), 0x5A5) * np.sqrt(2)
        self.s1_freq = np.zeros(m, np.complex128)
        self.s1_freq[self.active_idx] = _prbs_qpsk(len(self.active_idx), 0x3C3)
        # the generator's preamble is complex64, as the port stores it
        s0_t = (np.fft.ifft(s0) * np.sqrt(m)).astype(np.complex64)
        s1_t = (np.fft.ifft(self.s1_freq) * np.sqrt(m)).astype(np.complex64)
        self.preamble = np.concatenate([s0_t, s0_t, s1_t[-self.cp:], s1_t])
        hdr_enc = encoded_length(self.HEADER_FEC, HEADER_BYTES + PHY_HEADER_BYTES + 4)
        self.n_header_bits = hdr_enc * 8
        self.n_header_syms = -(-self.n_header_bits // nd)
        enc0 = encoded_length(self.fec0, payload_len + CRC_BYTES[self.crc])
        self.payload_enc_bytes = encoded_length(self.fec1, enc0)
        self.bps = BPS[self.mod]
        self.n_payload_syms = -(-(-(-self.payload_enc_bytes * 8 // self.bps)) // nd)
        self.num_symbols = self.n_header_syms + self.n_payload_syms
        self.frame_len = 2 * m + (m + self.cp) * (1 + self.num_symbols)
        n_pilots = max(len(self.pilot_idx), 1)
        bits = _prbs_bits(self.num_symbols * n_pilots, 0x2AA).astype(np.float64) * 2 - 1
        self.pilots = bits.reshape(self.num_symbols, -1)

    def phy_header(self) -> np.ndarray:
        p = self.payload_len
        return np.array([p & 0xFF, (p >> 8) & 0xFF, MOD_SCHEMES.index(self.mod),
                         FEC_SCHEMES.index(self.fec0), FEC_SCHEMES.index(self.fec1),
                         CRC_SCHEMES.index(self.crc)], np.uint8)

    def frames(self, headers: np.ndarray, payloads: np.ndarray) -> np.ndarray:
        """(B, 8) user headers and (B, P) payloads -> complex64 (B, frame_len)."""
        b = headers.shape[0]
        m, cp, nd = self.m, self.cp, len(self.data_idx)
        full = np.concatenate([headers, np.tile(self.phy_header(), (b, 1))], axis=1)
        full = np.concatenate([full, crc_bytes(self.HEADER_CRC, full)], axis=1)
        hbits = np.unpackbits(fec_encode(self.HEADER_FEC, full), axis=1)
        body = np.concatenate([payloads, crc_bytes(self.crc, payloads)], axis=1)
        pbits = np.unpackbits(fec_encode(self.fec1, fec_encode(self.fec0, body)), axis=1)
        hsyms = np.zeros((b, self.n_header_syms * nd), np.int64)
        hsyms[:, : hbits.shape[1]] = hbits
        pb = np.zeros((b, self.n_payload_syms * nd * self.bps), np.int64)
        pb[:, : pbits.shape[1]] = pbits
        psyms = (pb.reshape(b, -1, self.bps) << np.arange(self.bps - 1, -1, -1)).sum(-1)
        pts = np.concatenate([
            constellation(self.HEADER_MOD)[hsyms].reshape(b, self.n_header_syms, nd),
            constellation(self.mod)[psyms].reshape(b, self.n_payload_syms, nd),
        ], axis=1).astype(np.complex64)
        grid = np.zeros((b, self.num_symbols, m), np.complex64)
        grid[:, :, self.data_idx] = pts
        grid[:, :, self.pilot_idx] = self.pilots.astype(np.complex64)
        t = (np.fft.ifft(grid, axis=-1) * np.sqrt(m)).astype(np.complex64)
        sym = np.concatenate([t[..., -cp:], t], axis=-1)
        if self.taper:
            n = np.arange(self.taper) + 0.5
            ramp = np.sin(0.5 * np.pi * n / self.taper) ** 2
            sym[..., : self.taper] *= ramp.astype(np.float32)
        return np.concatenate([np.tile(self.preamble, (b, 1)), sym.reshape(b, -1)], axis=1)


# ---------------------------------------------------------------- soft values


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def soft_values(layout: FrameLayout, frames: np.ndarray, dtype=torch.float64) -> np.ndarray:
    """Per received frame (rows of ``frames``, complex, aligned at the frame's
    true start, ``frame_len`` samples): [cfo (rad/sample), rssi (dB), evm (dB)]
    as float64 (B, 3), computed in ``dtype`` throughout.

    CFO from the Schmidl&Cox autocorrelation over 3 half-symbols at the start;
    RSSI over the de-rotated frame; EVM over the header and payload points
    that carry coded bits, after a one-shot channel estimate on S1 and a
    common-phase correction from each symbol's pilots."""
    m, cp, half = layout.m, layout.cp, layout.m // 2
    fr = torch.as_tensor(np.ascontiguousarray(frames.real), dtype=torch.float64).to(dtype)
    fi = torch.as_tensor(np.ascontiguousarray(frames.imag), dtype=torch.float64).to(dtype)
    b, n = fr.shape
    pr, pi = _cmul(fr[:, half: half + 3 * half], fi[:, half: half + 3 * half],
                   fr[:, : 3 * half], -fi[:, : 3 * half])
    cfo = torch.atan2(pi.sum(1), pr.sum(1)) / half
    ang = -cfo[:, None] * torch.arange(n, dtype=torch.float64).to(dtype)
    rr, ri = _cmul(fr, fi, torch.cos(ang), torch.sin(ang))
    rssi = 10.0 * torch.log10((rr * rr + ri * ri).mean(1) + 1e-20)

    k = np.arange(m)
    w = -2.0 * np.pi * np.outer(k, k) / m
    wr = torch.as_tensor(np.cos(w)).to(dtype)
    wi = torch.as_tensor(np.sin(w)).to(dtype)
    scale = 1.0 / np.sqrt(m)

    def dft(xr, xi):
        return (xr @ wr - xi @ wi) * scale, (xr @ wi + xi @ wr) * scale

    s1 = 2 * m + cp
    y1r, y1i = dft(rr[:, s1: s1 + m], ri[:, s1: s1 + m])
    act = torch.as_tensor(layout.active_idx)
    x1 = layout.s1_freq[layout.active_idx]
    x1r = torch.as_tensor(x1.real / np.abs(x1) ** 2).to(dtype)
    x1i = torch.as_tensor(-x1.imag / np.abs(x1) ** 2).to(dtype)
    hr = torch.ones(b, m, dtype=dtype)
    hi = torch.zeros(b, m, dtype=dtype)
    hr[:, act], hi[:, act] = _cmul(y1r[:, act], y1i[:, act], x1r, x1i)

    nsym = layout.num_symbols
    body = slice(s1 + m, s1 + m + nsym * (m + cp))
    sr = rr[:, body].reshape(b, nsym, m + cp)[:, :, cp:]
    si = ri[:, body].reshape(b, nsym, m + cp)[:, :, cp:]
    yr, yi = dft(sr, si)
    den = hr * hr + hi * hi
    er, ei = _cmul(yr, yi, (hr / den)[:, None], (-hi / den)[:, None])  # y / h
    pidx = torch.as_tensor(layout.pilot_idx)
    if len(layout.pilot_idx):
        pil = torch.as_tensor(layout.pilots).to(dtype)
        dr = (er[:, :, pidx] * pil).sum(-1)
        di = (ei[:, :, pidx] * pil).sum(-1)
        mag = torch.sqrt(dr * dr + di * di)
        er, ei = _cmul(er, ei, (dr / mag)[..., None], (-di / mag)[..., None])
    didx = torch.as_tensor(layout.data_idx)
    pr_, pi_ = er[:, :, didx], ei[:, :, didx]
    nh = layout.n_header_syms
    hdr = (pr_[:, :nh].reshape(b, -1)[:, : layout.n_header_bits],
           pi_[:, :nh].reshape(b, -1)[:, : layout.n_header_bits])
    n_pay = layout.payload_enc_bytes * 8 // layout.bps
    pay = (pr_[:, nh:].reshape(b, -1)[:, :n_pay], pi_[:, nh:].reshape(b, -1)[:, :n_pay])

    def nearest(xr, xi, scheme):
        pts = constellation(scheme)
        cr = torch.as_tensor(pts.real).to(dtype)
        ci = torch.as_tensor(pts.imag).to(dtype)
        d2 = (xr[..., None] - cr) ** 2 + (xi[..., None] - ci) ** 2
        return d2.min(-1).values.sum(-1)

    err = nearest(*hdr, FrameLayout.HEADER_MOD) + nearest(*pay, layout.mod)
    evm = 10.0 * torch.log10(err / (layout.n_header_bits + n_pay) + 1e-20)
    return torch.stack([cfo, rssi, evm], 1).double().numpy()
