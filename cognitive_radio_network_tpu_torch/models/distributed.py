"""The wideband sense->classify apply step on one device.

Port of the serving end of ``cognitive_radio_network_tpu/models/distributed.py``:
:func:`wideband_features` and the one-device form of ``make_sharded_apply``.
The classifier is the sigmoid MLP applied per channel with shared weights
over features [noise_floor, E_{k-1}, E_k, E_{k+1}] (the wideband
generalization of CE_Predictive_Node's [NF, CH1, CH2, CH3] input,
CE_Predictive_Node.cpp:200); output 0 is the channel-occupied probability.
The reference's train step and its sharding over a device mesh are not part
of the one-device apply.
"""

from __future__ import annotations

import torch

from cognitive_radio_network_tpu_torch.parallel.wideband import WidebandConfig, wideband_sense
from cognitive_radio_network_tpu_torch.signal.mlp import OccupancyMLP, mlp_forward

__all__ = ["wideband_features", "make_sharded_apply"]


def wideband_features(energy: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Per-channel 4-feature rows: [noise, E_left, E_center, E_right].

    energy (..., C, M), noise (..., C, 1) -> (..., C, M, 4).  Neighbor
    energies wrap cyclically (channel 0's left neighbor is channel M-1).
    """
    left = torch.roll(energy, 1, dims=-1)
    right = torch.roll(energy, -1, dims=-1)
    nf = noise.expand_as(energy)
    return torch.stack([nf, left, energy, right], dim=-1)


def make_sharded_apply(cfg: WidebandConfig, *, device="cuda"):
    """Inference over a batch of streams: ``apply_fn(params, planes)`` with
    planes (B, T*M, 2) -> occupancy probabilities (B, C, M).

    The name is the reference's; on one device nothing is sharded.  Taps
    live on ``device`` (the card unless the caller asks for the CPU), and
    planes given as numpy or on another device are moved there.  ``params``
    is a 4-n-1 :class:`..signal.mlp.OccupancyMLP` on the same device."""
    device = torch.device(device)
    taps = torch.from_numpy(cfg.taps()).to(device)

    @torch.no_grad()
    def apply_fn(params: OccupancyMLP, planes) -> torch.Tensor:
        planes = torch.as_tensor(planes).to(device)
        res = wideband_sense(planes, taps, cfg)
        feats = wideband_features(res["energy"], res["noise"])
        return mlp_forward(params, torch.log1p(feats * 1e3))[..., 0]

    return apply_fn
