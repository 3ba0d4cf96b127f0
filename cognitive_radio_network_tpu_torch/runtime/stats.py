"""Sliding-window receive statistics.

Port of ``update_rx_stats`` (src/extensible_cognitive_radio.cpp:1462-1640):
a time-windowed ring of per-frame records producing frame counts, valid-frame
counts, **linear-domain** EVM/RSSI averages (the reference averages
10^(dB/10) then converts back, :1544-1566), PER, BER vs the known m-sequence
payload (:1586-1594), throughput, and overflow counts, fed back to the
scenario controller at a configurable period.

Port of ``cognitive_radio_network_tpu/runtime/stats.py``, copied.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from cognitive_radio_network_tpu_torch.signal.msequence import msequence_bytes

__all__ = ["RxStatistics", "RxStats"]


@dataclasses.dataclass
class RxStats:
    """The rx_statistics feedback struct
    (include/extensible_cognitive_radio.hpp:510-519)."""

    frames_received: int = 0
    valid_frames: int = 0
    evm_dB: float = 0.0
    rssi_dB: float = 0.0
    per: float = 0.0
    ber_uncoded: float = 0.0
    throughput_bps: float = 0.0
    uhd_overflows: int = 0


@dataclasses.dataclass
class _FrameRecord:
    t: float
    valid: bool
    evm_dB: float
    rssi_dB: float
    payload_bits: int
    bit_errors: int
    payload_len: int


class RxStatistics:
    def __init__(self, tracking_period_s: float = 1.0, packet_len: int = 256):
        self.period = tracking_period_s
        self.records: deque[_FrameRecord] = deque()
        self.overflows = 0
        # known payload for true-BER measurement: the first 4 bytes carry the
        # packet number on tx, so the oracle skips them
        # (src/extensible_cognitive_radio.cpp:88-94, crts.hpp:193)
        self.known_payload = msequence_bytes(packet_len)
        self.num_skip = 4

    def record_frame(self, t: float, valid: bool, evm_dB: float, rssi_dB: float,
                     payload: np.ndarray | None) -> None:
        bit_errors = 0
        nbits = 0
        plen = 0
        if payload is not None:
            plen = len(payload)
            n = min(plen, len(self.known_payload))
            if n > self.num_skip:
                a = np.asarray(payload[self.num_skip : n], np.uint8)
                b = self.known_payload[self.num_skip : n]
                bit_errors = int(np.unpackbits(a ^ b).sum())
                nbits = (n - self.num_skip) * 8
        self.records.append(
            _FrameRecord(t, valid, evm_dB, rssi_dB, nbits, bit_errors, plen)
        )

    def record_overflow(self) -> None:
        self.overflows += 1

    def _prune(self, now: float) -> None:
        while self.records and self.records[0].t < now - self.period:
            self.records.popleft()

    def snapshot(self, now: float) -> RxStats:
        self._prune(now)
        recs = list(self.records)
        n = len(recs)
        if n == 0:
            return RxStats(uhd_overflows=self.overflows)
        valid = [r for r in recs if r.valid]
        nv = len(valid)
        # linear-domain averaging then back to dB (reference :1544-1566)
        evm_lin = np.mean([10 ** (r.evm_dB / 10.0) for r in valid]) if nv else 0.0
        rssi_lin = np.mean([10 ** (r.rssi_dB / 10.0) for r in recs])
        bits = sum(r.payload_bits for r in valid)
        errs = sum(r.bit_errors for r in valid)
        payload_bytes = sum(r.payload_len for r in valid)
        return RxStats(
            frames_received=n,
            valid_frames=nv,
            evm_dB=float(10 * np.log10(evm_lin)) if nv else 0.0,
            rssi_dB=float(10 * np.log10(rssi_lin)) if rssi_lin > 0 else 0.0,
            per=float(1.0 - nv / n),
            ber_uncoded=float(errs / bits) if bits else 0.0,
            throughput_bps=float(payload_bytes * 8 / self.period),
            uhd_overflows=self.overflows,
        )

    def reset(self) -> None:
        self.records.clear()
        self.overflows = 0
