"""Filter/window design (host-side numpy; returns arrays consumed by kernels).

Replaces the liquid-dsp filter design routines the reference leans on:
``firfilt_crcf`` RRC design for the WCDMA-like interferer
(src/interferer.cpp:225-253), the Gaussian pulse of ``gmskframegen``, the
Blackman-Harris window of spectrum_analyzer.py:505-510, and the prototype
low-pass for the polyphase channelizer (new, per BASELINE config 5).
Design happens once at trace time in float64 numpy; the hot path only sees the
resulting coefficient arrays.

Copied unchanged from ``cognitive_radio_network_tpu/signal/filters.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "rrcos_taps",
    "gaussian_taps",
    "kaiser_lowpass_taps",
    "channelizer_prototype",
    "blackman_harris",
    "hamming",
]


def rrcos_taps(samps_per_sym: int, semilength: int, beta: float) -> np.ndarray:
    """Root-raised-cosine FIR, length 2*k*m+1 (k=samps/sym, m=semilength)."""
    k, m = samps_per_sym, semilength
    n = 2 * k * m + 1
    t = (np.arange(n) - (n - 1) / 2) / k
    taps = np.zeros(n)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-9:
            taps[i] = 1.0 - beta + 4.0 * beta / np.pi
        elif beta > 0 and abs(abs(ti) - 1.0 / (4.0 * beta)) < 1e-9:
            taps[i] = (
                beta
                / np.sqrt(2.0)
                * (
                    (1.0 + 2.0 / np.pi) * np.sin(np.pi / (4.0 * beta))
                    + (1.0 - 2.0 / np.pi) * np.cos(np.pi / (4.0 * beta))
                )
            )
        else:
            num = np.sin(np.pi * ti * (1.0 - beta)) + 4.0 * beta * ti * np.cos(
                np.pi * ti * (1.0 + beta)
            )
            den = np.pi * ti * (1.0 - (4.0 * beta * ti) ** 2)
            taps[i] = num / den
        # normalize energy below
    taps /= np.sqrt(np.sum(taps**2))
    return taps.astype(np.float32)


def gaussian_taps(samps_per_sym: int, semilength: int, bt: float) -> np.ndarray:
    """Gaussian pulse-shaping FIR for GMSK (BT product ``bt``)."""
    k, m = samps_per_sym, semilength
    n = 2 * k * m + 1
    t = (np.arange(n) - (n - 1) / 2) / k
    alpha = np.sqrt(np.log(2.0) / 2.0) / bt
    taps = (np.sqrt(np.pi) / alpha) * np.exp(-((np.pi * t / alpha) ** 2))
    taps /= np.sum(taps)
    return taps.astype(np.float32)


def kaiser_lowpass_taps(num_taps: int, cutoff: float, attenuation_db: float = 60.0) -> np.ndarray:
    """Windowed-sinc low-pass, normalized cutoff in cycles/sample (0, 0.5)."""
    a = attenuation_db
    if a > 50:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21)
    else:
        beta = 0.0
    n = np.arange(num_taps) - (num_taps - 1) / 2
    h = 2 * cutoff * np.sinc(2 * cutoff * n)
    w = np.i0(beta * np.sqrt(1 - (2 * n / (num_taps - 1)) ** 2)) / np.i0(beta)
    taps = h * w
    taps /= np.sum(taps)
    return taps.astype(np.float32)


def channelizer_prototype(num_channels: int, taps_per_channel: int) -> np.ndarray:
    """Prototype low-pass for an M-channel polyphase filterbank.

    Length M*P, cutoff 1/(2M), unit DC gain — combined with the FFT across
    phases this gives each channel unity passband gain for a centered tone.
    Returned flat; reshape to (P, M) for the phase decomposition.
    """
    m, p = num_channels, taps_per_channel
    return kaiser_lowpass_taps(m * p, 0.5 / m, 70.0).astype(np.float32)


def blackman_harris(n: int) -> np.ndarray:
    """4-term Blackman-Harris window (spectrum_analyzer.py FFT sink default)."""
    a = (0.35875, 0.48829, 0.14128, 0.01168)
    k = np.arange(n)
    w = (
        a[0]
        - a[1] * np.cos(2 * np.pi * k / (n - 1))
        + a[2] * np.cos(4 * np.pi * k / (n - 1))
        - a[3] * np.cos(6 * np.pi * k / (n - 1))
    )
    return w.astype(np.float32)


def hamming(n: int) -> np.ndarray:
    k = np.arange(n)
    return (0.54 - 0.46 * np.cos(2 * np.pi * k / (n - 1))).astype(np.float32)
