"""Batched spectrum estimation (port of ``cognitive_radio_network_tpu/signal/fft.py``).

The reference senses by running liquid-dsp's scalar 512-point FFT on one
buffer at a time and accumulating magnitude averages on the CPU
(CE_Predictive_Node.cpp:148-155).  The plain PyTorch versions here keep the
JAX package's three modes, as batched matmuls over any leading dims:

* ``dft_matmul``: dense X = x @ F with the real/imag split, four (N, N)
  matmuls;
* ``ct_matmul``: the Cooley-Tukey N = N1 x 128 split (radix-N1 adds, a
  twiddle, then 128-point DFT matmuls), the factorization of the fused kernel
  in :mod:`..ops.fused_sense_ct`;
* ``xla``: ``torch.fft.fft`` (the name is kept from the reference).

Precision ladder.  The reference's ``"highest"`` (f32) and ``"high"``
(bf16_3x on the TPU, ~5e-5 relative error) both map to a float32 matmul
with TF32 set off explicitly (:func:`..utils.device.full_f32`): TF32 keeps
about three digits and misses the ``"high"`` bounds.  ``"default"`` maps to
one bf16 matmul with float32 output, as the TPU's single bf16 pass.

The DFT and twiddle tables are built in float64 numpy and cast to float32,
which keeps their entries accurate to f32 ulp; the golden tests rely on it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.utils.device import full_f32

__all__ = [
    "PRECISIONS",
    "dft_matrices",
    "spectrum_magnitude",
    "averaged_magnitude_spectrum",
]

PRECISIONS = ("highest", "high", "default")

# Second-stage length of the ct_matmul split: N = N1 * 128, N1 in {2, 4}.
_CT_N2 = 128


@functools.lru_cache(maxsize=16)
def _dft_matrices_np(n: int) -> tuple[np.ndarray, np.ndarray]:
    k = np.arange(n)
    ang = -2.0 * np.pi * np.outer(k, k) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _ct_twiddles_np(n1: int, n2: int) -> tuple[np.ndarray, np.ndarray]:
    """W_N^(k1*n2) over (k1, n2), N = n1*n2, in float64 -> f32."""
    k1 = np.arange(n1)[:, None]
    n2i = np.arange(n2)[None, :]
    ang = -2.0 * np.pi * k1 * n2i / (n1 * n2)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _device_tables(kind: str, n1: int, n2: int, device: torch.device):
    """The float32 tables as tensors on ``device``, made once per device."""
    re, im = _dft_matrices_np(n2) if kind == "dft" else _ct_twiddles_np(n1, n2)
    return torch.from_numpy(re).to(device), torch.from_numpy(im).to(device)


def dft_matrices(
    n: int, dtype=torch.float32, device=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Real and imaginary parts of the forward DFT matrix ``exp(-2*pi*i*jk/n)``."""
    fre, fim = _dft_matrices_np(n)
    return (
        torch.as_tensor(fre, dtype=dtype, device=device),
        torch.as_tensor(fim, dtype=dtype, device=device),
    )


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` with float32 output at the given rung of the precision ladder."""
    if precision == "default":
        return torch.matmul(a.bfloat16(), b.bfloat16()).float()
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of {PRECISIONS}")
    with full_f32():
        return torch.matmul(a, b)


def _ct_spectrum_sq(xr: torch.Tensor, xi: torch.Tensor, precision: str) -> torch.Tensor:
    """|FFT|^2 via the N = n1 x 128 Cooley-Tukey split (n1 in {2, 4}).

    Stage 1: radix-n1 butterflies over x[n] = x[128*m1 + n2] (twiddles
    +-1 / +-i, so adds only).  Stage 2: multiply by W_N^(k1*n2).  Stage 3:
    the 128-point DFT as real-split (rows*n1, 128) @ (128, 128) matmuls.
    Output bin k = k1 + n1*k2, so the (k1, k2) axes are swapped at the end.
    """
    n = xr.shape[-1]
    n1 = n // _CT_N2
    lead = xr.shape[:-1]
    xr = xr.reshape(*lead, n1, _CT_N2)
    xi = xi.reshape(*lead, n1, _CT_N2)
    if n1 == 2:
        yr = torch.stack([xr[..., 0, :] + xr[..., 1, :], xr[..., 0, :] - xr[..., 1, :]], -2)
        yi = torch.stack([xi[..., 0, :] + xi[..., 1, :], xi[..., 0, :] - xi[..., 1, :]], -2)
    else:  # n1 == 4
        x0r, x1r, x2r, x3r = (xr[..., j, :] for j in range(4))
        x0i, x1i, x2i, x3i = (xi[..., j, :] for j in range(4))
        a_r, a_i = x0r + x2r, x0i + x2i  # x0 + x2
        b_r, b_i = x0r - x2r, x0i - x2i  # x0 - x2
        c_r, c_i = x1r + x3r, x1i + x3i  # x1 + x3
        d_r, d_i = x1r - x3r, x1i - x3i  # x1 - x3
        # k1 = 0: a+c; k1 = 2: a-c; k1 = 1: b - i*d; k1 = 3: b + i*d
        yr = torch.stack([a_r + c_r, b_r + d_i, a_r - c_r, b_r - d_i], -2)
        yi = torch.stack([a_i + c_i, b_i - d_r, a_i - c_i, b_i + d_r], -2)
    twr, twi = _device_tables("twiddle", n1, _CT_N2, xr.device)
    zr = yr * twr - yi * twi
    zi = yr * twi + yi * twr
    fre, fim = _device_tables("dft", 0, _CT_N2, xr.device)
    xre = _mm(zr, fre, precision) - _mm(zi, fim, precision)  # (..., n1, 128) as [k1, k2]
    xim = _mm(zr, fim, precision) + _mm(zi, fre, precision)
    sq = xre * xre + xim * xim
    return sq.transpose(-1, -2).reshape(*lead, n)


def spectrum_magnitude(x, *, mode: str = "dft_matmul", precision: str = "high") -> torch.Tensor:
    """|FFT(x)| over the sample axis.

    x: complex (..., N), float32 planes (..., N, 2), or a planar (xr, xi)
    tuple.  Returns float32 (..., N), the ``cabsf(buffer_F[i])`` of
    CE_Predictive_Node.cpp:153, batched.  ``ct_matmul`` needs N in
    {256, 512} and uses ``dft_matmul`` otherwise.
    """
    from cognitive_radio_network_tpu_torch.signal.iq import split_iq

    xr, xi = split_iq(x)
    n = xr.shape[-1]
    if mode == "xla":
        return torch.fft.fft(torch.complex(xr, xi), dim=-1).abs()
    if mode == "ct_matmul" and n // _CT_N2 in (2, 4) and n % _CT_N2 == 0:
        return torch.sqrt(_ct_spectrum_sq(xr, xi, precision))
    if mode not in ("dft_matmul", "ct_matmul"):
        raise ValueError(f"unknown spectrum mode: {mode}")
    fre, fim = _device_tables("dft", 0, n, xr.device)
    xre = _mm(xr, fre, precision) - _mm(xi, fim, precision)
    xim = _mm(xr, fim, precision) + _mm(xi, fre, precision)
    return torch.sqrt(xre * xre + xim * xim)


def averaged_magnitude_spectrum(
    blocks,
    *,
    averaging: int | None = None,
    mode: str = "dft_matmul",
    precision: str = "high",
) -> torch.Tensor:
    """Magnitude-average spectra over an averaging axis.

    blocks: complex (..., A, N), planes (..., A, N, 2), or a planar tuple of
    (..., A, N).  Returns float32 (..., N): ``sum_a |X_a[i]| / A`` (sum, then
    divide, as ``jnp.mean`` in the reference; CE_Predictive_Node.cpp:152-154
    accumulates |X|/A, which differs only by f32 rounding).
    """
    mags = spectrum_magnitude(blocks, mode=mode, precision=precision)
    if averaging is not None and mags.shape[-2] != averaging:
        raise ValueError(
            f"expected averaging axis {averaging}, got spectra of shape {tuple(mags.shape)}"
        )
    return mags.mean(dim=-2)
