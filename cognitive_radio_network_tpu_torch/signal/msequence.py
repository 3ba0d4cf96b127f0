"""Maximal-length sequence (PRBS) generator.

Port of ``cognitive_radio_network_tpu/signal/msequence.py`` (host numpy,
copied).

The reference uses liquid-dsp's ``msequence_create_default(12)`` to derive the
known network payload that serves as the BER ground-truth oracle
(src/crts_cognitive_radio.cpp:755-764, src/extensible_cognitive_radio.cpp:88-94).

This is a clean-room Fibonacci LFSR with the same *semantics* (m-bit shift
register, feedback = parity(state & genpoly), MSB-first symbol extraction):
the oracle only needs tx and rx to share one deterministic sequence, which
they do by construction.  Default generator polynomials are standard primitive
polynomials per degree.
"""

from __future__ import annotations

import numpy as np

__all__ = ["MSequence", "msequence_bytes", "DEFAULT_GENPOLY"]

# Primitive polynomials (feedback masks, x^m term implicit) per register length.
DEFAULT_GENPOLY = {
    2: 0x3,
    3: 0x5,
    4: 0x9,
    5: 0x12,
    6: 0x21,
    7: 0x44,
    8: 0x8E,
    9: 0x108,
    10: 0x204,
    11: 0x402,
    12: 0x829,  # x^12 + x^6 + x^4 + x + 1 -> taps mask over 12-bit state
    13: 0x100D,
    14: 0x2015,
    15: 0x4001,
}


class MSequence:
    """Fibonacci LFSR over an m-bit register.

    advance(): out_bit = msb(state); feedback = parity(state & genpoly);
    state = ((state << 1) | feedback) & (2^m - 1).
    """

    def __init__(self, m: int = 12, genpoly: int | None = None, init: int = 1):
        if genpoly is None:
            genpoly = DEFAULT_GENPOLY[m]
        self.m = m
        self.mask = (1 << m) - 1
        self.genpoly = genpoly & self.mask
        self.state = init & self.mask
        if self.state == 0:
            raise ValueError("LFSR state must be nonzero")

    def advance(self) -> int:
        fb = bin(self.state & self.genpoly).count("1") & 1
        out = (self.state >> (self.m - 1)) & 1
        self.state = ((self.state << 1) | fb) & self.mask
        return out

    def generate_symbol(self, bps: int) -> int:
        s = 0
        for _ in range(bps):
            s = (s << 1) | self.advance()
        return s


def msequence_bytes(n: int, m: int = 12, *, skip: int = 0) -> np.ndarray:
    """First ``n`` bytes of the default degree-``m`` PRBS, after ``skip`` bytes.

    Mirrors the reference's known-payload construction: the first
    CRTS_CR_PACKET_NUM_LEN(=4) symbols are drawn then *overwritten* by the
    packet number on tx, and the rx oracle regenerates them with ``skip``
    (src/extensible_cognitive_radio.cpp:90-94).
    """
    ms = MSequence(m)
    for _ in range(skip):
        ms.generate_symbol(8)
    return np.array([ms.generate_symbol(8) for _ in range(n)], dtype=np.uint8)
