"""Constellation mapping: the liquid ``modulation_scheme`` equivalents.

Port of ``cognitive_radio_network_tpu/phy/modem.py``.  Gray-coded
unit-energy constellations for the schemes the reference's config layer
accepts (qam4 default, qam16 in predictive_model.cfg:79, plus the rest of the
usual ladder).  The point tables are built by the same numpy code; modulate
is a gather and hard demod a min-distance search, batched over any leading
axes, on the device of the input.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["SCHEMES", "bits_per_symbol", "constellation", "modulate", "demodulate"]

SCHEMES = ("bpsk", "qpsk", "qam4", "psk8", "qam16", "qam64", "qam256")

_BPS = {
    "bpsk": 1,
    "qpsk": 2,
    "qam4": 2,
    "psk8": 3,
    "qam16": 4,
    "qam64": 6,
    "qam256": 8,
}


def bits_per_symbol(scheme: str) -> int:
    return _BPS[scheme]


def _gray(n: int) -> int:
    return n ^ (n >> 1)


@functools.lru_cache(maxsize=None)
def _constellation_np(scheme: str) -> np.ndarray:
    bps = _BPS[scheme]
    m = 1 << bps
    if scheme == "bpsk":
        pts = np.array([1.0 + 0j, -1.0 + 0j])
    elif scheme in ("qpsk", "qam4"):
        # Gray 2-bit: bit0 -> I sign, bit1 -> Q sign.
        pts = np.array(
            [1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j], dtype=np.complex128
        ) / np.sqrt(2)
    elif scheme == "psk8":
        # position k on the circle carries symbol gray(k) so neighbors differ
        # by one bit
        pts = np.zeros(8, np.complex128)
        for k in range(8):
            pts[_gray(k)] = np.exp(1j * (2 * np.pi * k / 8 + np.pi / 8))
    else:
        # square gray QAM: split bits evenly between I (MSBs) and Q (LSBs)
        half = bps // 2
        l = 1 << half
        pam = 2 * np.arange(l) - (l - 1)  # levels
        # gray index g at level position p: level_of_gray[gray(p)] = pam[p]
        level_of = np.zeros(l)
        for p in range(l):
            level_of[_gray(p)] = pam[p]
        pts = np.zeros(m, np.complex128)
        for s in range(m):
            i_bits, q_bits = s >> half, s & (l - 1)
            pts[s] = level_of[i_bits] + 1j * level_of[q_bits]
        pts /= np.sqrt(np.mean(np.abs(pts) ** 2))
    return pts.astype(np.complex64)


@functools.lru_cache(maxsize=64)
def _constellation_on(scheme: str, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_constellation_np(scheme)).to(device)


def constellation(scheme: str, device: torch.device | str = "cpu") -> torch.Tensor:
    """The scheme's points, complex64 (2**bps,), indexed by symbol value."""
    return _constellation_on(scheme, torch.device(device))


def modulate(scheme: str, symbols: torch.Tensor) -> torch.Tensor:
    """Symbol indices (..., S) int -> complex64 points on the same device."""
    return constellation(scheme, symbols.device)[symbols.long()]


def demodulate(scheme: str, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Hard demod: returns (symbol indices int32, evm per symbol float32).

    Min-distance over the constellation; the evm is the squared distance to
    the chosen point (ties go to the lower symbol index)."""
    pts = constellation(scheme, x.device)
    d2 = (x[..., None] - pts).abs() ** 2
    evm, idx = torch.min(d2, dim=-1)
    return idx.to(torch.int32), evm.float()
