"""Interferer waveform synthesis — the fault-injection subsystem.

Port of ``cognitive_radio_network_tpu/env/interference.py``.  The reference's
``Interferer`` node (src/interferer.cpp) is its only fault injector for the RF
environment: six waveform types with duty-cycle gating and fixed/sweep/random
frequency hopping.  Here each builder is batched PyTorch synthesis of a block
of samples on the generator's device; random draws come from a
``torch.Generator`` (as ``env/channel.py::awgn``), so they differ from the
reference's ``jax.random`` draws and are held to it by their statistics.

Waveform contracts (src/interferer.cpp:128-288, include/interferer.hpp:12-28):
  CW    constant 0.5 + 0.5j
  NOISE uniform per rail in [-0.25, 0.25)
  AWGN  Gaussian per rail, mean 5.0, std 5.0 — yes, a huge DC term; the
        reference constructs ``dist(5.0, 5.0)`` (src/interferer.cpp:24) and we
        default to the same (configurable)
  GMSK  Gaussian-filtered MSK frames, 2 samps/sym interpolated x2 (-> 4)
  RRC   root-raised-cosine QPSK, 2 samps/sym, semilength 32, beta 0.35,
        rails in {-0.25, +0.25}
  OFDM  random-payload OFDM symbols, M = 2*(tx_rate/30e3) subcarriers, CP 16

Frequency behaviors (src/interferer.cpp:334-355): SWEEP steps by
``tx_freq_resolution`` and reflects at [tx_freq_min, tx_freq_max]; RANDOM
quantizes a uniform draw over the band to the resolution grid.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.signal import filters
from cognitive_radio_network_tpu_torch.utils.device import full_f32

__all__ = ["InterfererConfig", "synthesize_interference", "hop_trace", "duty_cycle_gate"]

InterferenceType = Literal["cw", "noise", "awgn", "gmsk", "rrc", "ofdm"]


@dataclasses.dataclass(frozen=True)
class InterfererConfig:
    """Mirrors node_parameters' interferer block (include/crts.hpp:167-180)."""

    interference_type: InterferenceType = "cw"
    period_s: float = 1.0
    duty_cycle: float = 1.0
    tx_rate_hz: float = 1e6
    tx_gain_soft_db: float = -3.0
    tx_freq_behavior: Literal["fixed", "sweep", "random"] = "fixed"
    tx_freq_hz: float = 833e6
    tx_freq_min_hz: float = 833e6
    tx_freq_max_hz: float = 838e6
    tx_freq_dwell_s: float = 1.0
    tx_freq_resolution_hz: float = 1e6
    awgn_mean: float = 5.0
    awgn_std: float = 5.0


def _uniform(generator: torch.Generator, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device)


def _qpsk_rails(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Rails in {-0.25, +0.25}: 0.5*round(U[0,1)) - 0.25 (interferer.cpp:237-240)."""
    re = 0.5 * torch.round(_uniform(generator, shape, device)) - 0.25
    im = 0.5 * torch.round(_uniform(generator, shape, device)) - 0.25
    return torch.complex(re, im)


def _convolve_same(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """``numpy.convolve(x, taps, mode="same")`` for a real 1-D float32 ``x``:
    the centre len(x) samples of the full convolution."""
    n = len(taps)
    w = torch.from_numpy(np.ascontiguousarray(taps[::-1], np.float32)).to(x.device)
    with full_f32():
        full = torch.nn.functional.conv1d(x[None, None], w[None, None], padding=n - 1)[0, 0]
    start = (n - 1) // 2
    return full[start : start + x.shape[0]]


def synthesize_interference(
    generator: torch.Generator, cfg: InterfererConfig, num_samples: int, device=None
) -> torch.Tensor:
    """One ON-burst of ``num_samples`` complex64 baseband samples of the
    configured type, on ``device`` (default: the generator's device)."""
    device = generator.device if device is None else torch.device(device)
    t = cfg.interference_type
    if t == "cw":
        return torch.full((num_samples,), 0.5 + 0.5j, dtype=torch.complex64, device=device)
    if t == "noise":
        re = 0.5 * _uniform(generator, (num_samples,), device) - 0.25
        im = 0.5 * _uniform(generator, (num_samples,), device) - 0.25
        return torch.complex(re, im)
    if t == "awgn":
        kw = {"generator": generator, "device": device}
        re = cfg.awgn_mean + cfg.awgn_std * torch.randn((num_samples,), **kw)
        im = cfg.awgn_mean + cfg.awgn_std * torch.randn((num_samples,), **kw)
        return torch.complex(re, im)
    if t == "rrc":
        k_sym = 2
        n_sym = -(-num_samples // k_sym)
        syms = _qpsk_rails(generator, (n_sym,), device)
        up = torch.zeros((n_sym * k_sym,), dtype=torch.complex64, device=device)
        up[::k_sym] = syms
        taps = filters.rrcos_taps(2, 32, 0.35)
        out = torch.complex(_convolve_same(up.real, taps), _convolve_same(up.imag, taps))
        return out[:num_samples]
    if t == "gmsk":
        # 1 bit/sym at 2 samps/sym then x2 interpolation => 4 samps/bit.
        sps = 4
        n_bits = -(-num_samples // sps)
        bits = torch.bernoulli(torch.full((n_bits,), 0.5, device=device), generator=generator)
        nrz = 2.0 * bits - 1.0
        up = torch.zeros((n_bits * sps,), dtype=torch.float32, device=device)
        up[::sps] = nrz * sps
        freq = _convolve_same(up, filters.gaussian_taps(sps, 3, 0.3))
        # MSK phase ramp: pi/2 per bit.
        phase = torch.cumsum(freq, 0) * (np.pi / 2.0) / sps
        g_lin = 10.0 ** (cfg.tx_gain_soft_db / 20.0)
        return (g_lin * torch.polar(torch.ones_like(phase), phase))[:num_samples]
    if t == "ofdm":
        m = max(8, 2 * int(cfg.tx_rate_hz / 30e3))
        cp = 16
        sym_len = m + cp
        n_syms = -(-num_samples // sym_len)
        syms = _qpsk_rails(generator, (n_syms, m), device) * 4.0  # unit-ish power rails
        time_syms = torch.fft.ifft(syms, dim=-1) * np.float32(np.sqrt(m))
        with_cp = torch.cat([time_syms[:, -cp:], time_syms], dim=-1)
        g_lin = 10.0 ** (cfg.tx_gain_soft_db / 20.0)
        return (g_lin * with_cp.reshape(-1)[:num_samples]).to(torch.complex64)
    raise ValueError(f"unknown interference type: {t}")


def hop_trace(
    generator: torch.Generator, cfg: InterfererConfig, num_dwells: int, device=None
) -> torch.Tensor:
    """Center frequency per dwell interval (float32 Hz), on ``device``
    (default: the generator's device).

    "sweep" is the reference's ``lax.scan`` as a host loop in float32, step
    for step the same arithmetic, so the trace equals the reference's."""
    device = generator.device if device is None else torch.device(device)
    if cfg.tx_freq_behavior == "fixed":
        return torch.full((num_dwells,), cfg.tx_freq_hz, dtype=torch.float32, device=device)
    if cfg.tx_freq_behavior == "sweep":
        res = np.float32(cfg.tx_freq_resolution_hz)
        res2 = np.float32(2.0 * cfg.tx_freq_resolution_hz)
        lo, hi = np.float32(cfg.tx_freq_min_hz), np.float32(cfg.tx_freq_max_hz)
        freq, coeff = np.float32(cfg.tx_freq_hz), np.float32(1.0)
        trace = np.empty(num_dwells, np.float32)
        for i in range(num_dwells):
            freq = freq + res * coeff
            if freq > hi or freq < lo:
                coeff = -coeff
                freq = freq + res2 * coeff
            trace[i] = freq
        return torch.from_numpy(trace).to(device)
    if cfg.tx_freq_behavior == "random":
        bw = cfg.tx_freq_max_hz - cfg.tx_freq_min_hz
        draws = _uniform(generator, (num_dwells,), device) * bw
        return (
            cfg.tx_freq_resolution_hz * torch.round(draws / cfg.tx_freq_resolution_hz)
            + cfg.tx_freq_min_hz
        ).float()
    raise ValueError(f"unknown tx_freq_behavior: {cfg.tx_freq_behavior}")


def duty_cycle_gate(
    cfg: InterfererConfig, num_samples: int, sample_rate_hz: float, device="cuda"
) -> torch.Tensor:
    """0/1 ON mask implementing period/duty_cycle gating (interferer.cpp:394-420)."""
    period = max(int(round(cfg.period_s * sample_rate_hz)), 1)
    on = int(round(cfg.duty_cycle * period))
    idx = torch.arange(num_samples, device=device)
    return ((idx % period) < on).float()
