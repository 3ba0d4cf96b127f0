"""The receive streams of the link cells, made from the seed.

A stream is a cyclic tape of samples at the receiver's rate: frames of one
PHY, 256-byte packets paced as the CRTS stream traffic paces them (a packet
every ``8 * 256 / throughput`` seconds, sent when the previous frame has left
the air: a saturated link sends frame after frame), scaled by the
transmitter's gains, plus receiver noise.  The tape's length is a whole
number of frame periods, so replaying it is one endless, continuous stream.  Payload and header bytes and the first frame's position
come from the seed; every seed gives the same sizes and spacing.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from crn_bench.reference.phy import FrameLayout

PACKET_LEN = 256  # CRTS_CR_PACKET_LEN


def packet_interval_s(throughput_bps: float) -> float:
    """The CRTS stream traffic's interval between packets (runtime/traffic.py's rule)."""
    return PACKET_LEN * 8 / throughput_bps


@dataclasses.dataclass
class Tape:
    samples: np.ndarray  # complex64 (L,)
    starts: np.ndarray  # int64 (F,): each frame's first sample, cyclic
    headers: np.ndarray  # uint8 (F, 8)
    payloads: np.ndarray  # uint8 (F, PACKET_LEN)
    layout: FrameLayout

    def frame(self, j: int) -> np.ndarray:
        """Frame j's received samples (it may wrap round the tape's end)."""
        idx = (self.starts[j] + np.arange(self.layout.frame_len)) % len(self.samples)
        return self.samples[idx]


def link_snr_db(link: dict, medium: dict) -> float:
    """Mean signal power over noise power at the receiver, in dB."""
    layout = FrameLayout(link["phy"], PACKET_LEN)
    unit = len(layout.active_idx) / layout.m  # mean power of a frame at unit gain
    gain = 10.0 ** ((link["tx_gain"] + link["tx_gain_soft"]) / 10.0)
    return 10.0 * math.log10(unit * gain / noise_power(link, medium))


def noise_power(link: dict, medium: dict) -> float:
    """The medium's receiver-referred noise, decimated to the receiver's rate."""
    return medium["noise_power"] * link["rx_rate"] / medium["sample_rate"]


def make_tape(link: dict, medium: dict, min_samples: int, rng: np.random.Generator) -> Tape:
    layout = FrameLayout(link["phy"], PACKET_LEN)
    interval = packet_interval_s(link["throughput_bps"]) * link["rx_rate"]
    if interval != int(interval):
        raise ValueError(f"packet interval of {interval} samples is not whole")
    period = max(int(interval), layout.frame_len)
    count = max(1, -(-min_samples // period))
    length = period * count
    starts = (int(rng.integers(period)) + period * np.arange(count)) % length
    headers = rng.integers(0, 256, (count, 8), dtype=np.uint8)
    payloads = rng.integers(0, 256, (count, PACKET_LEN), dtype=np.uint8)
    sigma = math.sqrt(noise_power(link, medium) / 2)
    noise = rng.standard_normal((2, length), dtype=np.float32) * np.float32(sigma)
    tape = (noise[0] + 1j * noise[1]).astype(np.complex64)
    amp = np.float32(10.0 ** ((link["tx_gain"] + link["tx_gain_soft"]) / 20.0))
    frames = layout.frames(headers, payloads) * amp
    for j in range(count):
        idx = (starts[j] + np.arange(layout.frame_len)) % length
        tape[idx] += frames[j]
    return Tape(tape, starts.astype(np.int64), headers, payloads, layout)
