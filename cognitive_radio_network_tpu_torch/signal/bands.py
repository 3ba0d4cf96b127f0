"""Channel band-energy features (port of ``cognitive_radio_network_tpu/signal/bands.py``).

The reference sums *amplitudes* of DC-centered, **unshifted** FFT bins per
channel, then squares the sum to get a "power" feature
(CE_Predictive_Node.cpp:173-197):

* CH1 (833 MHz, the DC band): bins [0, 16) union [496, 511); the upper loop
  runs ``i < 511``, so bin 511 is *excluded* (15 bins), a reference quirk
  kept bit for bit;
* CH2 (835 MHz): bins [55, 85);
* CH3 (838 MHz): bins [189, 222);
* noise floor: bins [300, 310).

Feature order is ``Features_Buffer[1..4] = {NF, CH1, CH2, CH3}``
(CE_Predictive_Node.cpp:200).  The band sums are one (..., N) @ (N, 4)
matmul with a 0/1 indicator matrix.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.utils.device import full_f32

__all__ = ["SensingBands", "DEFAULT_BANDS", "band_matrix", "band_features"]


@dataclasses.dataclass(frozen=True)
class SensingBands:
    """Bin ranges (half-open [lo, hi) intervals) for each feature column.

    Column order is the feature order: (noise_floor, ch1, ch2, ch3).
    """

    fft_length: int = 512
    noise_floor: tuple[tuple[int, int], ...] = ((300, 310),)
    ch1: tuple[tuple[int, int], ...] = ((0, 16), (496, 511))  # 511 excluded: quirk
    ch2: tuple[tuple[int, int], ...] = ((55, 85),)
    ch3: tuple[tuple[int, int], ...] = ((189, 222),)

    @property
    def columns(self) -> tuple[tuple[tuple[int, int], ...], ...]:
        return (self.noise_floor, self.ch1, self.ch2, self.ch3)

    @staticmethod
    def for_grid(
        fft_length: int,
        sample_rate_hz: float,
        center_hz: float,
        channels_hz: tuple[float, ...],
        channel_bw_hz: float,
        noise_offset_hz: float,
    ) -> "SensingBands":
        """Derive band bin maps for arbitrary grids (beyond the 512/13e6 default).

        Bins are unshifted (DC at bin 0, negative freqs wrap to the top), like
        the reference's direct indexing of the liquid FFT output.
        """

        def bins_for(f_lo: float, f_hi: float) -> tuple[tuple[int, int], ...]:
            df = sample_rate_hz / fft_length
            lo = int(np.floor((f_lo - center_hz) / df))
            hi = int(np.ceil((f_hi - center_hz) / df))
            out = []
            if lo < 0 and hi > 0:
                out.append((0, hi))
                out.append((fft_length + lo, fft_length))
            elif lo < 0:
                out.append((fft_length + lo, fft_length + hi))
            else:
                out.append((lo, hi))
            return tuple(out)

        half = channel_bw_hz / 2
        cols = [bins_for(c - half, c + half) for c in channels_hz]
        nf = bins_for(center_hz + noise_offset_hz - half / 2, center_hz + noise_offset_hz + half / 2)
        return SensingBands(fft_length, nf, *cols)


DEFAULT_BANDS = SensingBands()


@functools.lru_cache(maxsize=16)
def _band_matrix_np(bands: SensingBands) -> np.ndarray:
    m = np.zeros((bands.fft_length, len(bands.columns)), dtype=np.float32)
    for col, ranges in enumerate(bands.columns):
        for lo, hi in ranges:
            m[lo:hi, col] = 1.0
    return m


@functools.lru_cache(maxsize=16)
def _device_band_matrix(bands: SensingBands, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_band_matrix_np(bands)).to(device)


def band_matrix(
    bands: SensingBands = DEFAULT_BANDS, dtype=torch.float32, device=None
) -> torch.Tensor:
    """(N, 4) 0/1 indicator matrix; column order (NF, CH1, CH2, CH3)."""
    return torch.as_tensor(_band_matrix_np(bands), dtype=dtype, device=device)


def band_features(
    avg_spectrum: torch.Tensor, bands: SensingBands = DEFAULT_BANDS
) -> torch.Tensor:
    """Features ``[NF, CH1, CH2, CH3]`` = (sum of band amplitudes)**2.

    avg_spectrum: float (..., N) averaged magnitude spectrum (already >= 0;
    the reference re-applies cabsf at CE_Predictive_Node.cpp:174, mirrored
    with abs).  Returns float32 (..., 4).
    """
    m = _device_band_matrix(bands, avg_spectrum.device)
    with full_f32():
        sums = torch.matmul(avg_spectrum.abs().float(), m)
    return sums * sums
