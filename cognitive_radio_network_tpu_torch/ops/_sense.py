"""What the two sense wrappers share: the input's shape check and the
kernels' tables.

``fused_sense_ct`` and ``fused_band_features`` launch two kernels over one
row transform (``csrc/fft512_warp.cuh``), so they take the same planes, the
same twiddle table and the same band matrix.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.signal import bands as bands_mod

__all__ = ["N", "band_matrix", "count_rows", "twiddles"]

N = 512


def count_rows(xr: torch.Tensor, xi: torch.Tensor, averaging: int, what: str) -> tuple[int, int]:
    """Check the planar input's shape, (C*A, N) or (C, A, N); return its number
    of rows C*A, and A (from the shape where it has three dimensions, as in the
    reference).  ``what`` names the caller in the error."""
    if xr.shape != xi.shape:
        raise ValueError(f"xr {tuple(xr.shape)} and xi {tuple(xi.shape)} differ in shape")
    if xr.ndim == 3:
        averaging = xr.shape[1]
    elif xr.ndim != 2:
        raise ValueError(f"expected (C*A, N) or (C, A, N) planes, got {tuple(xr.shape)}")
    n = xr.shape[-1]
    if n != N:
        raise ValueError(f"{what} requires N={N}, got {n}")
    rows = xr.numel() // n
    if averaging < 1 or rows % averaging:
        raise ValueError(f"rows {rows} not divisible by averaging {averaging}")
    return rows, averaging


@functools.lru_cache(maxsize=8)
def twiddles(device: torch.device) -> torch.Tensor:
    """(2, 512) float32 cos/sin of -2*pi*k/512, built in float64: the whole
    circle, since the kernels' lane n2 takes W_512^(n2 k1) for k1 up to 15."""
    ang = -2.0 * np.pi * np.arange(N) / N
    return torch.from_numpy(np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)).to(device)


def band_matrix(bands: bands_mod.SensingBands, device: torch.device) -> torch.Tensor:
    """The (512, 4) band indicator matrix on ``device``, as the kernels read it."""
    band = bands_mod._device_band_matrix(bands, device)
    if band.shape != (N, 4):
        raise ValueError(f"kernel takes a ({N}, 4) band matrix, got {tuple(band.shape)}")
    return band
