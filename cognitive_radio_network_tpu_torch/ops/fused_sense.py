"""The features-only sense chain: IQ planes -> band-energy features.

Port of ``cognitive_radio_network_tpu/ops/fused_sense.py`` (the Pallas TPU
kernel ``_kernel``) to a CUDA C++ kernel for Hopper, ``csrc/fused_sense.cu``.
Per cycle of A buffers of 512 samples:

    512-point DFT in full float32 -> |X| -> mean over the A rows -> band
    amplitude sums through the (512, 4) indicator matrix -> squared

A drop-in for ``averaged_magnitude_spectrum`` + ``band_features`` with the
same numerical contract (full float32), and the same features as
:func:`..fused_sense_ct.fused_sense_ct` returns beside its spectrum.  The TPU
kernel takes its spectrum from a dense (512, 512) product on the matrix unit;
the CUDA kernel takes it from the register FFT it shares with
``csrc/fused_sense_ct.cu`` and writes no spectrum.

:func:`fused_band_features` launches the kernel for CUDA tensors and runs
:func:`fused_band_features_plain` (the TPU kernel's steps: four matmuls against
the dense DFT matrices, magnitude, mean, band matmul, square) for CPU tensors.
The choice follows the tensor's device only; on a CUDA tensor the wrapper
launches the kernel or raises.  The reference's ``tile_c`` argument, and its rule that C be a multiple of it, belong to the
TPU's tiling and have no counterpart: any C >= 0 is valid.
"""

from __future__ import annotations

import torch

from cognitive_radio_network_tpu_torch.ops._launch import input_ptr, launch
from cognitive_radio_network_tpu_torch.ops._sense import N as _N
from cognitive_radio_network_tpu_torch.ops._sense import band_matrix, count_rows, twiddles
from cognitive_radio_network_tpu_torch.signal import bands as bands_mod
from cognitive_radio_network_tpu_torch.signal.fft import _device_tables, _mm
from cognitive_radio_network_tpu_torch.utils.device import on_cuda

__all__ = ["fused_band_features", "fused_band_features_plain"]


def _rows(iq_planes, averaging: int):
    """Check the input; return contiguous buffers-flat planes (C*A, N) with A.

    ``iq_planes``: (C, A, N, 2) float32 planes (A comes from the shape, as in
    the reference; de-interleaved here with one copy per plane), or a planar
    ``(xr, xi)`` tuple of (C*A, N) or (C, A, N) tensors, which passes through
    without a copy."""
    if isinstance(iq_planes, (tuple, list)):
        xr, xi = iq_planes
    else:
        if iq_planes.dim() != 4 or iq_planes.shape[-1] != 2:
            raise ValueError(f"expected (C, A, N, 2) planes, got {tuple(iq_planes.shape)}")
        xr, xi = iq_planes[..., 0], iq_planes[..., 1]  # (C, A, N): A from the shape
    rows, averaging = count_rows(xr, xi, averaging, "fused_band_features")
    return xr.reshape(rows, _N).contiguous(), xi.reshape(rows, _N).contiguous(), averaging


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
    float32 on one card (contiguous planar planes pass without a copy; the
    kernel loads scalars, so any alignment of a float will do).  Each launch
    adds one to
    ``fused_band_features.launches``.
    """
    first = iq_planes[0] if isinstance(iq_planes, (tuple, list)) else iq_planes
    if not on_cuda(first):
        return fused_band_features_plain(iq_planes, averaging=averaging, bands=bands)
    xr, xi, a = _rows(iq_planes, averaging)
    dev = xr.device
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise TypeError(f"kernel takes float32 planes, got {xr.dtype}, {xi.dtype}")
    p_xr = input_ptr(xr, "xr", dev)
    p_xi = input_ptr(xi, "xi", dev)
    band = band_matrix(bands, dev)
    c = xr.shape[0] // a
    feats = xr.new_empty((c, 4))
    if c == 0:
        return feats
    launch(
        "crn_fused_sense", dev,
        p_xr, p_xi, twiddles(dev).data_ptr(), band.data_ptr(), feats.data_ptr(), c, a,
    )
    fused_band_features.launches += 1
    return feats


fused_band_features.launches = 0
