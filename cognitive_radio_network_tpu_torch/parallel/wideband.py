"""Wideband sense pipeline: 64-channel channelizer -> energy detect, on one device.

Port of ``cognitive_radio_network_tpu/parallel/wideband.py`` (BASELINE.json
config 5's per-chip building block).  The pipeline:

    wide IQ planes (T*M, 2), or a planar (xr, xi) tuple of (T*M,) streams
      -> polyphase FIR + M-point DFT + per-cycle per-channel energy
         [ops.fused_wideband: one CUDA kernel on the card]
      -> noise-floor estimate across channels
      -> per-channel occupancy decisions (energy detector); the energies and
         the floor also feed the shared-weight per-channel MLP
         (models/distributed.py)

The reference lays this graph over a ('time', 'channel'[, 'data']) device
mesh, with a halo exchange for the FIR state between time shards; this module
holds the one-device form, so it takes no ``mesh`` and no ``batch_axis``.
Which energy path runs follows the input: a stream whose shape the fused path
takes goes through ``wideband_energy_fused`` (the kernel for a CUDA tensor,
its plain version for a CPU tensor), a batch of such streams one call per
stream; another shape, or ``use_fused=False``, goes through
:func:`wideband_energy_packed`.  (The reference keeps its kernel to the
unbatched stream and sends a batch through its packed XLA form; here a batch
on the card runs the kernel too.)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.ops.fused_wideband import (
    _energy_rows,
    wideband_energy_fused,
)
from cognitive_radio_network_tpu_torch.signal.channelizer import polyphase_taps
from cognitive_radio_network_tpu_torch.signal.iq import split_iq

__all__ = ["WidebandConfig", "wideband_sense", "wideband_energy_packed", "make_wideband_fn"]


@dataclasses.dataclass(frozen=True)
class WidebandConfig:
    num_channels: int = 64
    taps_per_channel: int = 8
    block_len: int = 128  # per-channel samples per sense cycle
    threshold_ratio: float = 4.0  # occupancy if energy > ratio * noise floor
    # matmul precision of the plain paths.  The reference's three rungs are
    # two code paths here: "highest" and "high" are both float32 with TF32
    # off, "default" is one bf16 pass.  The kernel computes in float32 at
    # every rung.
    precision: str = "high"

    def taps(self) -> np.ndarray:
        return polyphase_taps(self.num_channels, self.taps_per_channel)


def wideband_energy_packed(
    xr: torch.Tensor,
    xi: torch.Tensor,
    taps,
    cfg: WidebandConfig,
    *,
    precision: str = "high",
) -> torch.Tensor:
    """Planar wide stream -> per-cycle channel energy, in plain PyTorch.

    Factored polyphase formulation: the FIR is P shifted multiply-adds on
    (T, 2M) rows [vr | vi] (depthwise: the dense (P*M, M) matrix of
    signal/channelizer.py multiplies the window again for every output), and
    the M-point DFT is one (T, 2M) @ (2M, 2M) complex-packed product.
    Energy only: the channelized IQ is never materialized.

    xr/xi: (T*M,) float32, or (..., T*M) with leading batch dimensions, each
    row a stream of its own whose FIR starts from rest.  Returns (C, M) or
    (..., C, M) with C = T / block_len.
    """
    m = cfg.num_channels
    taps = torch.as_tensor(taps, dtype=torch.float32, device=xr.device)
    t_total = xr.shape[-1] // m
    if xr.shape[-1] % m or t_total % cfg.block_len:
        raise ValueError(f"T={t_total} must be a multiple of block_len")
    return _energy_rows(xr, xi, taps, cfg.block_len, None, precision)


def wideband_sense(
    planes,
    taps,
    cfg: WidebandConfig,
    *,
    use_fused: bool | None = None,
):
    """planes: (T*M, 2) / (B, T*M, 2) wide IQ at rate M * per-channel rate,
    or a planar tuple (xr, xi) of (T*M,) streams (the layout the kernel
    reads, so the card path makes no copy).

    Returns dict:
      energy   (..., C, M)  per-cycle per-channel mean power
      noise    (..., C, 1)  cross-channel noise-floor estimate
      occupied (..., C, M)  boolean energy-detector decisions
    with C = T / block_len sense cycles.

    The energy never needs the channelized IQ.  A stream goes through
    :func:`..ops.fused_wideband.wideband_energy_fused` when its shape allows
    (``use_fused=None`` selects it whenever M=64, P=8, block_len and T are
    even; the wrapper launches the kernel on a CUDA tensor), and a batch of
    streams goes through it stream by stream, each from rest: B launches.
    ``use_fused=True`` on another shape raises; ``use_fused=False`` takes
    :func:`wideband_energy_packed`.
    """
    m = cfg.num_channels
    if isinstance(planes, (tuple, list)):
        xr, xi = planes
    else:
        xr, xi = split_iq(planes)  # one copy per plane: the kernel reads contiguous planes
    t_total = xr.shape[-1] // m
    if xr.shape[-1] % m or t_total % cfg.block_len:
        raise ValueError(
            f"{xr.shape[-1]} wide samples do not divide into sense cycles of "
            f"{cfg.block_len} x {m}"
        )
    fused_ok = (
        m == 64 and cfg.taps_per_channel == 8 and cfg.block_len % 2 == 0 and t_total % 2 == 0
    )
    if use_fused is None:
        use_fused = fused_ok
    elif use_fused and not fused_ok:
        raise ValueError("fused path needs M=64, P=8, even block_len")
    if not use_fused:
        energy = wideband_energy_packed(xr, xi, taps, cfg, precision=cfg.precision)
    elif xr.dim() == 1:
        energy = wideband_energy_fused(xr, xi, taps, cfg, precision=cfg.precision)
    else:
        lead, n_wide = xr.shape[:-1], xr.shape[-1]
        rows = [
            wideband_energy_fused(r, i, taps, cfg, precision=cfg.precision)
            for r, i in zip(xr.reshape(-1, n_wide), xi.reshape(-1, n_wide))
        ]
        cycles = t_total // cfg.block_len
        energy = torch.stack(rows) if rows else xr.new_zeros((0, cycles, m))
        energy = energy.reshape(*lead, cycles, m)

    # Noise floor: a sort-free estimate from the channels' mean and minimum.
    mean_e = energy.mean(dim=-1, keepdim=True)
    min_e = energy.amin(dim=-1, keepdim=True)
    noise = 0.5 * (min_e + torch.minimum(mean_e, 2.0 * min_e))
    occupied = energy > cfg.threshold_ratio * noise
    return {"energy": energy, "noise": noise, "occupied": occupied}


def make_wideband_fn(cfg: WidebandConfig, *, device="cuda"):
    """The wideband pipeline bound to ``cfg``, its taps on ``device`` (the
    card unless the caller asks for the CPU): ``fn(planes)`` takes what
    :func:`wideband_sense` takes, as tensors or numpy arrays, and moves it
    to ``device`` first if it lies elsewhere."""
    device = torch.device(device)
    taps = torch.from_numpy(cfg.taps()).to(device)

    def place(x):
        return torch.as_tensor(x).to(device)

    @torch.no_grad()
    def fn(planes, *, use_fused: bool | None = None):
        if isinstance(planes, (tuple, list)):
            planes = tuple(place(v) for v in planes)
        else:
            planes = place(planes)
        return wideband_sense(planes, taps, cfg, use_fused=use_fused)

    return fn
