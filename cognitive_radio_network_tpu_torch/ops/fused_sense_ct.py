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

import torch

from cognitive_radio_network_tpu_torch.ops._launch import input_ptr, launch
from cognitive_radio_network_tpu_torch.ops._sense import N as _N
from cognitive_radio_network_tpu_torch.ops._sense import band_matrix, count_rows, twiddles
from cognitive_radio_network_tpu_torch.signal import bands as bands_mod
from cognitive_radio_network_tpu_torch.signal.fft import PRECISIONS, spectrum_magnitude
from cognitive_radio_network_tpu_torch.utils.device import on_cuda

__all__ = ["fused_sense_ct", "fused_sense_ct_plain"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _rows(xr: torch.Tensor, xi: torch.Tensor, averaging: int):
    """Check the planar input; return it buffers-flat (C*A, N) with A."""
    rows, averaging = count_rows(xr, xi, averaging, "fused_sense_ct")
    return xr.reshape(rows, _N), xi.reshape(rows, _N), averaging


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
    current stream, without synchronizing; they must be contiguous (the
    kernel loads scalars: any alignment of the element type).  Each launch adds one to ``fused_sense_ct.launches``.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of {PRECISIONS}")
    if not on_cuda(xr):
        return fused_sense_ct_plain(xr, xi, averaging=averaging, bands=bands, precision=precision)
    dev = xr.device
    if xr.dtype not in _KERNEL_DTYPES or xi.dtype != xr.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16 planes, got {xr.dtype}, {xi.dtype}")
    p_xr = input_ptr(xr, "xr", dev)
    p_xi = input_ptr(xi, "xi", dev)
    # contiguous: (C, A, N) is (C*A, N) in memory
    rows, a = count_rows(xr, xi, averaging, "fused_sense_ct")
    band = band_matrix(bands, dev)
    c = rows // a
    avg = xr.new_empty((c, _N), dtype=torch.float32)
    feats = xr.new_empty((c, 4), dtype=torch.float32)
    if c == 0:
        return avg, feats
    launch(
        "crn_fused_sense_ct", dev,
        p_xr, p_xi, int(xr.dtype == torch.bfloat16), twiddles(dev).data_ptr(), band.data_ptr(),
        avg.data_ptr(), feats.data_ptr(), c, a,
    )
    fused_sense_ct.launches += 1
    return avg, feats


fused_sense_ct.launches = 0
