"""Channel impairments and frequency translation (port of
``cognitive_radio_network_tpu/env/channel.py``), batched over leading dims."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["awgn", "mix_to_offset", "apply_cfo", "soft_gain"]


def awgn(generator: torch.Generator, x: torch.Tensor, snr_db) -> torch.Tensor:
    """Add complex white Gaussian noise at the given SNR vs the signal power."""
    p_sig = torch.mean(x.abs() ** 2)
    p_noise = p_sig / (10.0 ** (torch.as_tensor(snr_db, dtype=torch.float32) / 10.0))
    kw = {"generator": generator, "device": x.device}
    noise = torch.complex(torch.randn(x.shape, **kw), torch.randn(x.shape, **kw))
    return x + torch.sqrt(p_noise / 2.0) * noise


def _rotator(phase_per_sample: torch.Tensor, n: int, t0, device) -> torch.Tensor:
    t = (torch.arange(n, device=device) + torch.as_tensor(t0, device=device)).float()
    ph = phase_per_sample.float()[..., None] * t
    return torch.complex(torch.cos(ph), torch.sin(ph))


def mix_to_offset(x: torch.Tensor, offset_hz, sample_rate_hz: float, t0=0) -> torch.Tensor:
    """Frequency-translate baseband ``x`` by ``offset_hz`` (complex mixer).

    ``t0`` is the starting sample index so segment-wise synthesis stays
    phase-continuous across block boundaries.
    """
    ph = 2.0 * np.pi * torch.as_tensor(offset_hz, dtype=torch.float32, device=x.device)
    return x * _rotator(ph / sample_rate_hz, x.shape[-1], t0, x.device)


def apply_cfo(x: torch.Tensor, cfo_rad_per_samp, t0=0) -> torch.Tensor:
    """Apply a carrier-frequency offset given in radians/sample."""
    cfo = torch.as_tensor(cfo_rad_per_samp, dtype=torch.float32, device=x.device)
    return x * _rotator(cfo, x.shape[-1], t0, x.device)


def soft_gain(gain_db) -> torch.Tensor:
    """Linear amplitude from dB soft gain: 10^(g/20)
    (reference src/extensible_cognitive_radio.cpp:892)."""
    return 10.0 ** (torch.as_tensor(gain_db, dtype=torch.float32) / 20.0)
