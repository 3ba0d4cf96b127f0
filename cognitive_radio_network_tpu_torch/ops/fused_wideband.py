"""The fused 64-channel wideband energy detector: wide stream -> per-cycle channel energy.

Port of ``cognitive_radio_network_tpu/ops/fused_wideband.py`` (the Pallas TPU
kernel ``_kernel``) to a CUDA C++ kernel for Hopper,
``csrc/fused_wideband.cu``.  Per sense cycle of ``block_len`` channel-rate
times it computes the 64-channel generalisation of the reference's joint
3-channel sensing (CE_Predictive_Node.cpp:146-197):

    8-tap polyphase FIR per channel -> 64-point DFT over the channel axis
    -> |y|^2 -> mean over the cycle's times

with the FIR, the DFT, the power and the mean in one kernel, so device memory
sees the input once and (C, 64) energies.

:func:`wideband_energy_fused` launches the kernel for CUDA tensors and runs
:func:`wideband_energy_fused_plain`, the plain PyTorch version of the same
contract (shifted multiply-adds, one (T, 128) @ (128, 128) product, power,
mean), for CPU tensors.  The choice follows the tensor's device only; on a
CUDA tensor the wrapper launches the kernel or raises.

The kernel computes in float32 at every ``precision``; the argument selects
the matmul precision of the plain version only.  The reference's ``tile_q``
and ``interpret`` arguments, and its rule that T*M divide into
(2M x tile_q) tiles, belong to the TPU's tiling and have no counterpart.

The FIR's tap order lives here once, in :func:`_fir_rows`;
``parallel/wideband.py::wideband_energy_packed`` runs the same rows.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.ops._launch import input_ptr, launch
from cognitive_radio_network_tpu_torch.signal.channelizer import _dft_tables
from cognitive_radio_network_tpu_torch.signal.fft import PRECISIONS, _mm
from cognitive_radio_network_tpu_torch.utils.device import on_cuda

__all__ = ["wideband_energy_fused", "wideband_energy_fused_plain"]

_M = 64  # channels of the kernel
_P = 8  # taps per channel of the kernel (delays 0..7)


@functools.lru_cache(maxsize=32)
def _dft_complex_block(m: int, device: torch.device) -> torch.Tensor:
    """(2M, 2M) real matrix of the length-M DFT of lane-concat complex rows:
    [yr | yi] = [vr | vi] @ [[Wre, Wim], [-Wim, Wre]]."""
    wre, wim = _dft_tables(m, device)
    return torch.cat([torch.cat([wre, wim], dim=1), torch.cat([-wim, wre], dim=1)], dim=0)


def _fir_rows(v_in: torch.Tensor, taps: torch.Tensor, history: torch.Tensor | None) -> torch.Tensor:
    """Depthwise polyphase FIR on lane-concat planes.

    v_in: (..., T, 2M) rows [xr_phases | xi_phases]; taps (P, M).  Returns
    (..., T, 2M) with v[t, c] = sum_d taps[d, c] * v_in[t - d, c] per plane:
    P shifted multiply-adds, from the oldest delay to the newest, no matmul.
    ``history`` (..., P-1, 2M) holds the rows before the first one
    (overlap-save carry; zeros when None)."""
    p = taps.shape[0]
    t = v_in.shape[-2]
    hf = torch.flip(taps.float(), dims=(0,))
    hf2 = torch.cat([hf, hf], dim=1)  # (P, 2M): the same taps for both planes
    if history is None:
        history = v_in.new_zeros((*v_in.shape[:-2], p - 1, v_in.shape[-1]))
    ext = torch.cat([history, v_in], dim=-2)  # (..., T + P - 1, 2M)
    v = hf2[0] * ext[..., 0:t, :]
    for s in range(1, p):
        v = v + hf2[s] * ext[..., s : s + t, :]
    return v


def _energy_rows(
    xr: torch.Tensor,
    xi: torch.Tensor,
    taps: torch.Tensor,
    block_len: int,
    history: torch.Tensor | None,
    precision: str,
) -> torch.Tensor:
    """xr/xi (..., T*M) planar streams -> (..., T/block_len, M) cycle energies:
    FIR rows, one complex-packed DFT matmul, power, mean over each cycle."""
    m = taps.shape[1]
    lead = xr.shape[:-1]
    t_total = xr.shape[-1] // m
    v_in = torch.cat([xr.reshape(*lead, t_total, m), xi.reshape(*lead, t_total, m)], dim=-1)
    v = _fir_rows(v_in.float(), taps, history)
    y = _mm(v, _dft_complex_block(m, v.device), precision)
    power = y[..., :m] ** 2 + y[..., m:] ** 2
    return power.reshape(*lead, t_total // block_len, block_len, m).mean(dim=-2)


def _check(xr, xi, taps, cfg, initial_history):
    """The contract of the kernel and of its plain version; returns T."""
    m, p = cfg.num_channels, cfg.taps_per_channel
    if (m, p) != (_M, _P):
        raise ValueError(f"fused path requires M=64, P=8, got {(m, p)}")
    if cfg.block_len < 2 or cfg.block_len % 2:
        raise ValueError(f"block_len must be even, got {cfg.block_len}")
    if tuple(taps.shape) != (_P, _M):
        raise ValueError(f"taps must be ({_P}, {_M}), got {tuple(taps.shape)}")
    if xr.dim() != 1 or xr.shape != xi.shape:
        raise ValueError(
            f"expected planar streams (T*M,), got {tuple(xr.shape)} and {tuple(xi.shape)}"
        )
    if xr.shape[0] % m or (xr.shape[0] // m) % cfg.block_len:
        raise ValueError(
            f"T*M = {xr.shape[0]} must hold whole sense cycles of {cfg.block_len} x {m} samples"
        )
    if initial_history is not None:
        for hist in initial_history:
            if tuple(hist.shape) != (4, 2 * m):
                raise ValueError(f"initial_history rows must be (4, {2 * m})")
    return xr.shape[0] // m


def wideband_energy_fused_plain(
    xr: torch.Tensor,
    xi: torch.Tensor,
    taps,
    cfg,
    *,
    precision: str = "high",
    initial_history: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (C, 64) float32 cycle energies.

    ``initial_history`` is in the reference's pair rows, (4, 128) per plane:
    row q holds the wide sample times 2q and 2q+1, so it reshapes to the 8
    phase rows before the stream, of which the FIR needs the last 7."""
    taps = torch.as_tensor(taps, dtype=torch.float32, device=xr.device)
    _check(xr, xi, taps, cfg, initial_history)
    history = None
    if initial_history is not None:
        hist_r, hist_i = (h.float().reshape(_P, _M)[1:] for h in initial_history)
        history = torch.cat([hist_r, hist_i], dim=1)  # (7, 128), as _fir_rows takes it
    return _energy_rows(xr, xi, taps, cfg.block_len, history, precision)


@functools.lru_cache(maxsize=8)
def _twiddles(device: torch.device) -> torch.Tensor:
    """(2, 32) float32 cos/sin of -2*pi*k/64, built in float64."""
    ang = -2.0 * np.pi * np.arange(_M // 2) / _M
    return torch.from_numpy(np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)).to(device)


def _kernel_plane(x: torch.Tensor, what: str, device: torch.device) -> int:
    """The address of float32 kernel input ``x`` after its checks."""
    if x.dtype != torch.float32:
        raise TypeError(f"kernel takes float32 {what}, got {x.dtype}")
    return input_ptr(x, what, device, aligned=True)


def wideband_energy_fused(
    xr: torch.Tensor,
    xi: torch.Tensor,
    taps,
    cfg,
    *,
    precision: str = "high",
    initial_history: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """xr/xi: (T*M,) float32 planar wide stream -> (C, M) per-cycle channel
    energies, C = T / cfg.block_len.  Numerically matches
    ``parallel/wideband.py::wideband_energy_packed`` (same taps, same DFT).

    Requires M=64, P=8, an even ``block_len`` and T a multiple of it.
    ``initial_history``: optional (hist_r, hist_i), each (4, 2M) float32, the
    4 pair rows (8 wide sample times) right before this stream, which seed
    the FIR instead of rest-from-zero (the carry between two parts of one
    stream).

    CPU tensors run :func:`wideband_energy_fused_plain`.  CUDA tensors launch
    the kernel on the current stream, without synchronizing; the planes must
    be contiguous, 16-byte aligned float32 on one card.  Each launch adds one
    to ``wideband_energy_fused.launches``.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of {PRECISIONS}")
    if not on_cuda(xr):
        return wideband_energy_fused_plain(
            xr, xi, taps, cfg, precision=precision, initial_history=initial_history
        )
    dev = xr.device
    taps = torch.as_tensor(taps, dtype=torch.float32, device=dev)
    t_total = _check(xr, xi, taps, cfg, initial_history)
    p_xr = _kernel_plane(xr, "xr", dev)
    p_xi = _kernel_plane(xi, "xi", dev)
    taps = taps.contiguous()
    hist = (None, None)
    if initial_history is not None:
        hist = tuple(_kernel_plane(h, "initial_history", dev) for h in initial_history)
    c = t_total // cfg.block_len
    out = xr.new_empty((c, _M))
    if c == 0:
        return out
    launch(
        "crn_fused_wideband", dev,
        p_xr, p_xi, taps.data_ptr(), _twiddles(dev).data_ptr(), hist[0], hist[1], out.data_ptr(),
        c, cfg.block_len,
    )
    wideband_energy_fused.launches += 1
    return out


wideband_energy_fused.launches = 0
