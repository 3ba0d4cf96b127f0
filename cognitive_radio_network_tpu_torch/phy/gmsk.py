"""GMSK frame generation (port of ``cognitive_radio_network_tpu/phy/gmsk.py``).

The reference uses liquid's GMSK framegen purely as an interference source
(BuildGMSKTransmission, src/interferer.cpp:161-219: random 8-byte header +
50-byte payload, CRC-16, Hamming(7,4) outer FEC, 2 samps/sym interpolated
x2); it never demodulates GMSK.  The frame's bits are coded on the host
(:mod:`.crc`, :mod:`.fec`, the m-sequence preamble), then modulated on
``device``: NRZ impulses through the Gaussian pulse filter, the phase
integrated at pi/2 per bit (in float64), a constant-envelope complex
exponential.
"""

from __future__ import annotations

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.env.interference import _convolve_same
from cognitive_radio_network_tpu_torch.phy import crc as crc_mod
from cognitive_radio_network_tpu_torch.phy import fec as fec_mod
from cognitive_radio_network_tpu_torch.phy.bits import unpack_bits
from cognitive_radio_network_tpu_torch.signal import filters
from cognitive_radio_network_tpu_torch.signal.msequence import msequence_bytes

__all__ = ["gmsk_modulate", "gmsk_frame", "GMSK_HEADER_LEN", "GMSK_PAYLOAD_LEN"]

GMSK_HEADER_LEN = 8  # include/interferer.hpp:16
GMSK_PAYLOAD_LEN = 50  # include/interferer.hpp:15
_BT = 0.3
_PREAMBLE_BITS = 63  # m-sequence preamble for ramp-up/detection


def gmsk_modulate(bits, sps: int = 4, bt: float = _BT, *, device="cuda") -> torch.Tensor:
    """bits {0,1} (numpy or a tensor) -> complex64 GMSK at ``sps`` samples/bit
    on ``device`` (the card unless the caller asks for the CPU)."""
    bits = torch.as_tensor(bits).to(device=device, dtype=torch.float32)
    up = torch.zeros(bits.shape[0] * sps, dtype=torch.float32, device=bits.device)
    up[::sps] = 2.0 * bits - 1.0
    freq = _convolve_same(up, filters.gaussian_taps(sps, 3, bt))
    # the phase grows by pi/2 a bit: float64 keeps it exact to far below float32's
    # spacing at the phases a long frame reaches
    phase = torch.cumsum(freq.double(), 0) * (np.pi / 2.0)
    return torch.polar(torch.ones_like(phase), phase).to(torch.complex64)


def gmsk_frame(
    rng: np.random.Generator,
    payload_len: int = GMSK_PAYLOAD_LEN,
    sps: int = 4,
    soft_gain_db: float = 0.0,
    *,
    device="cuda",
) -> torch.Tensor:
    """One frame with a random header and payload from ``rng``, CRC-16 and
    Hamming(7,4) (the reference's gmskCrcScheme/FecSchemeOuter,
    src/interferer.cpp:162-180), modulated on ``device``."""
    header = rng.integers(0, 256, GMSK_HEADER_LEN).astype(np.uint8)
    payload = rng.integers(0, 256, payload_len).astype(np.uint8)
    body = np.concatenate([header, payload])
    coded = fec_mod.encode("h74", np.concatenate([body, crc_mod.crc_generate("crc16", body)]))
    pre = unpack_bits(msequence_bytes(_PREAMBLE_BITS // 8 + 1))[:_PREAMBLE_BITS]
    bits = np.concatenate([pre, unpack_bits(coded), np.zeros(6, np.uint8)])
    g = np.float32(10.0 ** (soft_gain_db / 20.0))
    return g * gmsk_modulate(bits, sps, device=device)
