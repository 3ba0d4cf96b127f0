"""The fused sense chain: IQ rows -> averaged spectrum + band features.

Port of ``cognitive_radio_network_tpu/ops/fused_sense_ct.py`` (the Pallas
TPU kernel ``_kernel``) to a CUDA C++ kernel for Hopper,
``csrc/fused_sense_ct.cu``.  Per cycle of A buffers of 512 samples it
computes the sensing math of CE_Predictive_Node.cpp:146-197:

    512-point FFT of each row -> |X| -> mean over the A rows -> band
    amplitude sums through the (512, 4) indicator matrix -> squared

:func:`fused_sense_ct` launches the kernel for CUDA tensors and runs
:func:`fused_sense_ct_plain`, the plain PyTorch version of the same contract
(radix-4 -> twiddle -> 128-point DFT matmul -> |X| -> mean -> band matmul ->
square), for CPU tensors.  The choice follows the tensor's device only; on a
CUDA tensor the wrapper launches the kernel or raises.

The kernel computes in float32 at every ``precision``; the argument selects
the matmul precision of the plain version only.  The kernel's source note
says what bounds it on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.signal import bands as bands_mod
from cognitive_radio_network_tpu_torch.signal.fft import PRECISIONS, spectrum_magnitude
from cognitive_radio_network_tpu_torch.utils.device import on_cuda

__all__ = ["fused_sense_ct", "fused_sense_ct_plain"]

_N = 512
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _rows(xr: torch.Tensor, xi: torch.Tensor, averaging: int):
    """Check the planar input; return it buffers-flat (C*A, N) with A."""
    if xr.shape != xi.shape:
        raise ValueError(f"xr {tuple(xr.shape)} and xi {tuple(xi.shape)} differ in shape")
    if xr.dim() == 3:  # (C, A, N): A comes from the shape, as in the reference
        averaging = xr.shape[1]
    elif xr.dim() != 2:
        raise ValueError(f"expected (C*A, N) or (C, A, N) planes, got {tuple(xr.shape)}")
    n = xr.shape[-1]
    if n != _N:
        raise ValueError(f"fused_sense_ct requires N={_N}, got {n}")
    rows = xr.numel() // n
    if averaging < 1 or rows % averaging:
        raise ValueError(f"rows {rows} not divisible by averaging {averaging}")
    return xr.reshape(rows, n), xi.reshape(rows, n), averaging


def fused_sense_ct_plain(
    xr: torch.Tensor,
    xi: torch.Tensor,
    *,
    averaging: int = 10,
    bands: bands_mod.SensingBands = bands_mod.DEFAULT_BANDS,
    precision: str = "high",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (avg (C, 512), feats (C, 4)), float32.

    bf16 input is upcast first, as the kernel does after its load.
    """
    xr, xi, a = _rows(xr, xi, averaging)
    mags = spectrum_magnitude((xr.float(), xi.float()), mode="ct_matmul", precision=precision)
    avg = mags.reshape(-1, a, _N).mean(dim=1)
    return avg, bands_mod.band_features(avg, bands)


@functools.lru_cache(maxsize=8)
def _twiddles(device: torch.device) -> torch.Tensor:
    """(2, 256) float32 cos/sin of -2*pi*k/512, built in float64."""
    ang = -2.0 * np.pi * np.arange(_N // 2) / _N
    return torch.from_numpy(np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)).to(device)


def fused_sense_ct(
    xr: torch.Tensor,
    xi: torch.Tensor,
    *,
    averaging: int = 10,
    bands: bands_mod.SensingBands = bands_mod.DEFAULT_BANDS,
    precision: str = "high",
) -> tuple[torch.Tensor, torch.Tensor]:
    """IQ for C cycles -> (avg_spectrum (C, 512), features (C, 4)), float32.

    ``xr``, ``xi``: planar planes, buffers-flat (C*A, 512) (the layout the
    kernel reads) or (C, A, 512), float32 or bfloat16.  CPU tensors run
    :func:`fused_sense_ct_plain`.  CUDA tensors launch the kernel on the
    current stream, without synchronizing; they must be contiguous and
    16-byte aligned.  Each launch adds one to ``fused_sense_ct.launches``.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of {PRECISIONS}")
    if not on_cuda(xr):
        return fused_sense_ct_plain(xr, xi, averaging=averaging, bands=bands, precision=precision)
    if xi.device != xr.device:
        raise ValueError(f"xr on {xr.device} but xi on {xi.device}")
    if xr.dtype not in _KERNEL_DTYPES or xi.dtype != xr.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16 planes, got {xr.dtype}, {xi.dtype}")
    if not (xr.is_contiguous() and xi.is_contiguous()):
        raise ValueError("kernel takes contiguous planes")
    if xr.data_ptr() % 16 or xi.data_ptr() % 16:
        raise ValueError("kernel takes 16-byte aligned planes")
    xr, xi, a = _rows(xr, xi, averaging)
    band = bands_mod._device_band_matrix(bands, xr.device)
    if band.shape != (_N, 4):
        raise ValueError(f"kernel takes a ({_N}, 4) band matrix, got {tuple(band.shape)}")
    c = xr.shape[0] // a
    avg = torch.empty((c, _N), dtype=torch.float32, device=xr.device)
    feats = torch.empty((c, 4), dtype=torch.float32, device=xr.device)
    if c == 0:
        return avg, feats
    from cognitive_radio_network_tpu_torch.ops import _build

    lib = _build.load()
    with torch.cuda.device(xr.device):
        err = lib.crn_fused_sense_ct(
            xr.data_ptr(),
            xi.data_ptr(),
            int(xr.dtype == torch.bfloat16),
            _twiddles(xr.device).data_ptr(),
            band.data_ptr(),
            avg.data_ptr(),
            feats.data_ptr(),
            c,
            a,
            torch.cuda.current_stream(xr.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_sense_ct kernel launch failed: CUDA error {err}")
    fused_sense_ct.launches += 1
    return avg, feats


fused_sense_ct.launches = 0
