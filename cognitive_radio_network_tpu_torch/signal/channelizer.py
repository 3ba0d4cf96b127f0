"""Critically-sampled polyphase analysis channelizer.

Port of ``cognitive_radio_network_tpu/signal/channelizer.py``.  The wideband
scale-out primitive: splits one wide IQ stream into M equal channels with an
M-phase FIR filterbank and a length-M DFT.  The reference testbed has no
equivalent (its 3 channels are sensed jointly in one 512-point FFT); this is
what makes 64-channel wideband sensing possible.

Math (standard polyphase analysis, commutator form):
    xp[t, c] = x[t*M + c]                       (phase decomposition)
    v[t, c]  = sum_p h[p, c] * xp[t-p, c]       (per-phase FIR, taps (P, M))
    y[t, k]  = sum_c v[t, c] e^{-2 pi i c k/M}  (= fft(v[t]))
so channel k is x mixed down from centre frequency +k/M * fs and decimated
by M through the prototype low-pass (unit passband gain: a unit tone at a
channel centre gives a unit-amplitude channel output).

The FIR and the DFT fold into one matrix,
    y[t, k] = sum_{s,c} G[s*M + c, k] * xp[t - (P-1) + s, c]
with G[s*M+c, k] = W_M^{ck} * h[P-1-s, c]: overlapping (P*M)-wide frames of
the phase rows times a constant (P*M, M) matrix, four real
(T, P*M) @ (P*M, M) products (real/imaginary split).  The reference leaves
these products to its compiler, outside any hand-written kernel, and so they
are ``torch.matmul`` here (``signal/fft.py::_mm``: float32 with TF32 off at
"highest" and "high", one bf16 pass at "default").  The only state that
crosses blocks is the last P-1 phase rows, the ``history`` argument.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.signal import filters
from cognitive_radio_network_tpu_torch.signal.fft import _mm

__all__ = ["polyphase_taps", "channelize", "channelize_planes"]


def polyphase_taps(num_channels: int, taps_per_channel: int = 8) -> np.ndarray:
    """(P, M) float32 phase-decomposed prototype low-pass."""
    proto = filters.channelizer_prototype(num_channels, taps_per_channel)
    return proto.reshape(taps_per_channel, num_channels)


@functools.lru_cache(maxsize=32)
def _dft_tables(m: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of -2*pi*c*k/M as (M, M) float32 tensors, built in float64."""
    ang = -2.0 * np.pi * np.outer(np.arange(m), np.arange(m)) / m
    return (
        torch.from_numpy(np.cos(ang).astype(np.float32)).to(device),
        torch.from_numpy(np.sin(ang).astype(np.float32)).to(device),
    )


def _fir_dft_matrices(taps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Combined FIR+DFT matrix G (P*M, M): G[s*M+c, k] = W_M^(ck) h[P-1-s, c]."""
    p, m = taps.shape
    wre, wim = _dft_tables(m, taps.device)
    t = torch.flip(taps.float(), dims=(0,))[:, :, None]  # (P, M, 1)
    gre = (wre[None] * t).reshape(p * m, m)
    gim = (wim[None] * t).reshape(p * m, m)
    return gre, gim


def _frames(rows: torch.Tensor, p: int) -> torch.Tensor:
    """Overlapping windows: rows (..., T + P - 1, M) -> (..., T, P*M)."""
    t = rows.shape[-2] - (p - 1)
    return torch.cat([rows[..., s : s + t, :] for s in range(p)], dim=-1)


def _channelize_rows(xr, xi, taps, history_r, history_i, precision):
    p = taps.shape[0]
    gre, gim = _fir_dft_matrices(taps)
    fr = _frames(torch.cat([history_r, xr], dim=-2), p)
    fi = _frames(torch.cat([history_i, xi], dim=-2), p)
    yre = _mm(fr, gre, precision) - _mm(fi, gim, precision)
    yim = _mm(fr, gim, precision) + _mm(fi, gre, precision)
    return yre, yim


def channelize(
    x: torch.Tensor,
    taps,
    *,
    history: torch.Tensor | None = None,
    precision: str = "highest",
) -> torch.Tensor:
    """x: complex (..., T*M) wide stream -> complex64 (..., T, M) per-channel streams.

    ``history``: optional complex (..., P-1, M) phase rows from the previous
    block (overlap-save carry); with them the FIR starts where the previous
    block ended, so block boundaries are seamless.
    """
    taps = torch.as_tensor(taps, dtype=torch.float32, device=x.device)
    p, m = taps.shape
    xp = x.reshape(*x.shape[:-1], -1, m)
    if history is None:
        history = xp.new_zeros((*xp.shape[:-2], p - 1, m))
    yre, yim = _channelize_rows(
        xp.real.float(), xp.imag.float(), taps, history.real.float(), history.imag.float(), precision
    )
    return torch.complex(yre, yim)


def channelize_planes(
    planes: torch.Tensor,
    taps,
    *,
    history: torch.Tensor | None = None,
    precision: str = "high",
) -> torch.Tensor:
    """Planes variant: (..., T*M, 2) -> (..., T, M, 2); no complex anywhere.
    ``history``: optional (..., P-1, M, 2) phase rows from the previous block."""
    taps = torch.as_tensor(taps, dtype=torch.float32, device=planes.device)
    p, m = taps.shape
    xp = planes.float().reshape(*planes.shape[:-2], -1, m, 2)
    if history is None:
        history = xp.new_zeros((*xp.shape[:-3], p - 1, m, 2))
    yre, yim = _channelize_rows(
        xp[..., 0], xp[..., 1], taps, history[..., 0].float(), history[..., 1].float(), precision
    )
    return torch.stack([yre, yim], dim=-1)
