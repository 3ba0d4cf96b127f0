"""The dense-DFT sense chain: IQ planes -> band-energy features.

Port of ``cognitive_radio_network_tpu/ops/fused_sense.py`` (the Pallas TPU
kernel ``_kernel``) to a CUDA C++ kernel for Hopper, ``csrc/fused_sense.cu``.
Per cycle of A buffers of 512 samples:

    dense 512-point DFT as float32 matrix products
    (xre = xr Fre - xi Fim, xim = xr Fim + xi Fre) -> |X| -> mean over the A
    rows -> band amplitude sums through the (512, 4) indicator matrix -> squared

A drop-in for ``averaged_magnitude_spectrum`` + ``band_features`` with the
same numerical contract (full float32), and the same features as
:func:`..fused_sense_ct.fused_sense_ct` returns beside its spectrum.

:func:`fused_band_features` launches the kernel for CUDA tensors and runs
:func:`fused_band_features_plain` (four matmuls, magnitude, mean, band matmul,
square) for CPU tensors.  The choice follows the tensor's device only; on a
CUDA tensor the wrapper launches the kernel or raises.  The reference's
``tile_c`` argument, and its rule that C be a multiple of it, belong to the
TPU's tiling and have no counterpart: any C >= 0 is valid.
"""

from __future__ import annotations

import torch

from cognitive_radio_network_tpu_torch.ops._launch import input_ptr, launch
from cognitive_radio_network_tpu_torch.signal import bands as bands_mod
from cognitive_radio_network_tpu_torch.signal.fft import _device_tables, _mm
from cognitive_radio_network_tpu_torch.utils.device import on_cuda

__all__ = ["fused_band_features", "fused_band_features_plain"]

_N = 512


def _rows(iq_planes, averaging: int):
    """Check the input; return contiguous buffers-flat planes (C*A, N) with A.

    ``iq_planes``: (C, A, N, 2) float32 planes (A comes from the shape, as in
    the reference; de-interleaved here with one copy per plane), or a planar
    ``(xr, xi)`` tuple of (C*A, N) or (C, A, N) tensors, which passes through
    without a copy."""
    if isinstance(iq_planes, (tuple, list)):
        xr, xi = iq_planes
        if xr.shape != xi.shape:
            raise ValueError(f"xr {tuple(xr.shape)} and xi {tuple(xi.shape)} differ in shape")
        if xr.dim() == 3:
            averaging = xr.shape[1]
        elif xr.dim() != 2:
            raise ValueError(f"expected (C*A, N) or (C, A, N) planes, got {tuple(xr.shape)}")
    else:
        if iq_planes.dim() != 4 or iq_planes.shape[-1] != 2:
            raise ValueError(f"expected (C, A, N, 2) planes, got {tuple(iq_planes.shape)}")
        averaging = iq_planes.shape[1]
        xr, xi = iq_planes[..., 0], iq_planes[..., 1]
    n = xr.shape[-1]
    if n != _N:
        raise ValueError(f"fused_band_features requires N={_N}, got {n}")
    rows = xr.numel() // n
    if averaging < 1 or rows % averaging:
        raise ValueError(f"rows {rows} not divisible by averaging {averaging}")
    return xr.reshape(rows, n).contiguous(), xi.reshape(rows, n).contiguous(), averaging


def fused_band_features_plain(
    iq_planes,
    *,
    averaging: int = 10,
    bands: bands_mod.SensingBands = bands_mod.DEFAULT_BANDS,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (C, 4) float32 features, every
    product in full float32 (the reference's f32-HIGHEST)."""
    xr, xi, a = _rows(iq_planes, averaging)
    xr, xi = xr.float(), xi.float()
    fre, fim = _device_tables("dft", 0, _N, xr.device)
    xre = _mm(xr, fre, "highest") - _mm(xi, fim, "highest")
    xim = _mm(xr, fim, "highest") + _mm(xi, fre, "highest")
    mag = torch.sqrt(xre * xre + xim * xim)
    avg = mag.reshape(xr.shape[0] // a, a, _N).mean(dim=1)
    return bands_mod.band_features(avg, bands)


def fused_band_features(
    iq_planes,
    *,
    averaging: int = 10,
    bands: bands_mod.SensingBands = bands_mod.DEFAULT_BANDS,
) -> torch.Tensor:
    """(C, A, N, 2) float32 IQ planes, or a planar (xr, xi) tuple of (C*A, N)
    or (C, A, N) tensors -> (C, 4) band-energy features, float32.

    CPU tensors run :func:`fused_band_features_plain`.  CUDA tensors launch
    the kernel on the current stream, without synchronizing; they must be
    float32 on one card (planar planes that are contiguous and 16-byte
    aligned pass without a copy).  Each launch adds one to
    ``fused_band_features.launches``.
    """
    first = iq_planes[0] if isinstance(iq_planes, (tuple, list)) else iq_planes
    if not on_cuda(first):
        return fused_band_features_plain(iq_planes, averaging=averaging, bands=bands)
    xr, xi, a = _rows(iq_planes, averaging)
    dev = xr.device
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise TypeError(f"kernel takes float32 planes, got {xr.dtype}, {xi.dtype}")
    p_xr = input_ptr(xr, "xr", dev, aligned=True)
    p_xi = input_ptr(xi, "xi", dev, aligned=True)
    band = bands_mod._device_band_matrix(bands, dev)
    if band.shape != (_N, 4):
        raise ValueError(f"kernel takes a ({_N}, 4) band matrix, got {tuple(band.shape)}")
    fre, fim = _device_tables("dft", 0, _N, dev)
    c = xr.shape[0] // a
    feats = xr.new_empty((c, 4))
    if c == 0:
        return feats
    launch(
        "crn_fused_sense", dev,
        p_xr, p_xi, fre.data_ptr(), fim.data_ptr(), band.data_ptr(), feats.data_ptr(), c, a,
    )
    fused_band_features.launches += 1
    return feats


fused_band_features.launches = 0
