"""Scene composition (port of ``cognitive_radio_network_tpu/env/scene.py``).

Replaces the over-the-air data plane of the reference testbed: what the SU's
USRP would receive at fc=833 MHz / 13 MS/s (CE_Predictive_Node.hpp:42-43) is
synthesized directly as (cycles, samples_per_cycle) complex64 blocks.

Per sense cycle each occupied channel contributes a band-limited signal
(low-pass-filtered complex noise mixed to the channel offset: the spectral
footprint of the reference's OFDM links) on top of a complex-Gaussian noise
floor.  Everything is batched over cycles on the device of the power matrix;
the band-limiting filter is a depthwise ``conv1d`` in full float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from cognitive_radio_network_tpu_torch.signal import filters
from cognitive_radio_network_tpu_torch.utils.device import full_f32

__all__ = ["SceneConfig", "synthesize_scene", "occupancy_to_powers"]


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    sample_rate_hz: float = 13e6
    center_hz: float = 833e6
    channels_hz: tuple[float, ...] = (833e6, 835e6, 838e6)
    signal_bw_hz: float = 1.4e6  # PU link rate (scenarios/predictive_model.cfg:39)
    noise_floor_power: float = 1e-3
    filter_taps: int = 129


def occupancy_to_powers(
    trace: torch.Tensor, num_channels: int = 3, power: float = 1.0
) -> torch.Tensor:
    """Channel-index trace (C,) -> per-channel linear power matrix (C, K).

    Index -1 (or >= K) means no channel active that cycle.
    """
    trace = torch.as_tensor(trace)
    valid = (trace >= 0) & (trace < num_channels)
    onehot = F.one_hot(trace.long().clamp(0, num_channels - 1), num_channels)
    return (onehot * valid[:, None]).float() * power


def _convolve_same(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Row-wise ``numpy.convolve(row, taps, "same")`` for real (B, n) rows.

    ``conv1d`` cross-correlates, so the taps are flipped; numpy's "same"
    keeps the full convolution from index (L-1)//2, which sets the padding.
    """
    ell = taps.shape[0]
    left = ell - 1 - (ell - 1) // 2
    xp = F.pad(x[:, None, :], (left, (ell - 1) // 2))
    with full_f32():
        return F.conv1d(xp, taps.flip(0).reshape(1, 1, ell))[:, 0, :]


def synthesize_scene(
    generator: torch.Generator,
    channel_powers: torch.Tensor,
    samples_per_cycle: int,
    cfg: SceneConfig = SceneConfig(),
    *,
    as_planes: bool = False,
) -> torch.Tensor:
    """(C, K) per-cycle channel powers -> (C, samples_per_cycle) complex64 IQ,
    or float32 planes (C, samples_per_cycle, 2) with ``as_planes=True``.

    Runs on the device of ``channel_powers``; ``generator`` must live there.
    """
    c, k = channel_powers.shape
    n = samples_per_cycle
    device = channel_powers.device
    taps = torch.from_numpy(
        filters.kaiser_lowpass_taps(
            cfg.filter_taps, cfg.signal_bw_hz / 2.0 / cfg.sample_rate_hz, 60.0
        )
    ).to(device)
    # Normalize so filtered unit-power noise keeps unit power.
    taps = taps / torch.sqrt(torch.sum(taps * taps))

    def cnormal() -> tuple[torch.Tensor, torch.Tensor]:
        kw = {"generator": generator, "device": device}
        return torch.randn(c, n, **kw), torch.randn(c, n, **kw)

    t = torch.arange(n, dtype=torch.float32, device=device)
    total = torch.zeros((c, n), dtype=torch.complex64, device=device)
    for ch in range(k):
        wr, wi = cnormal()
        sig = _convolve_same(torch.cat([wr, wi]) / np.sqrt(2.0), taps)
        off = np.float32((cfg.channels_hz[ch] - cfg.center_hz) / cfg.sample_rate_hz)
        phase = np.float32(2.0 * np.pi) * off * t
        lo = torch.complex(torch.cos(phase), torch.sin(phase))
        amp = torch.sqrt(channel_powers[:, ch].float())[:, None]
        total = total + amp * torch.complex(sig[:c], sig[c:]) * lo[None, :]

    nr, ni = cnormal()
    out = total + torch.complex(nr, ni) * float(np.sqrt(cfg.noise_floor_power / 2.0))
    if as_planes:
        return torch.stack([out.real, out.imag], dim=-1).float()
    return out
