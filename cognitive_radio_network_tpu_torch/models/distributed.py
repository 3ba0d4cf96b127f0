"""The wideband sense->classify train and apply steps on one device.

Port of ``cognitive_radio_network_tpu/models/distributed.py``:
:func:`wideband_features` and the one-device forms of
``make_sharded_train_step`` and ``make_sharded_apply``.  The classifier is the
sigmoid MLP applied per channel with shared weights over features
[noise_floor, E_{k-1}, E_k, E_{k+1}] (the wideband generalization of
CE_Predictive_Node's [NF, CH1, CH2, CH3] input, CE_Predictive_Node.cpp:200);
output 0 is the channel-occupied probability.  The reference lays both steps
over a device mesh (batch, time and channel axes) with replicated
parameters; here one device holds everything, so neither takes a mesh.
"""

from __future__ import annotations

import torch

from cognitive_radio_network_tpu_torch.models.train import (
    TrainConfig,
    TrainState,
    _bce,
    _descend,
    make_optimizer,
)
from cognitive_radio_network_tpu_torch.parallel.wideband import WidebandConfig, wideband_sense
from cognitive_radio_network_tpu_torch.signal.mlp import OccupancyMLP, init_mlp, mlp_forward

__all__ = ["wideband_features", "make_sharded_train_step", "make_sharded_apply"]


def wideband_features(energy: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Per-channel 4-feature rows: [noise, E_left, E_center, E_right].

    energy (..., C, M), noise (..., C, 1) -> (..., C, M, 4).  Neighbor
    energies wrap cyclically (channel 0's left neighbor is channel M-1).
    """
    left = torch.roll(energy, 1, dims=-1)
    right = torch.roll(energy, -1, dims=-1)
    nf = noise.expand_as(energy)
    return torch.stack([nf, left, energy, right], dim=-1)


def _loss(params: OccupancyMLP, feats, labels) -> torch.Tensor:
    """feats (..., 4) raw energies, log-compressed here; labels (...,) in {0,1}."""
    return _bce(mlp_forward(params, torch.log1p(feats * 1e3))[..., 0], labels)


def make_sharded_train_step(cfg: WidebandConfig, learning_rate: float = 1e-3, *, device="cuda"):
    """Returns ``(init_fn, step_fn)`` on ``device`` (the card unless the caller
    asks for the CPU).

    ``init_fn(generator)`` draws a 4-5-1 network and its Adam optimizer (a
    :class:`..models.train.TrainState`).  ``step_fn(state, planes (B, T*M, 2),
    labels (B, C, M)) -> (state, loss)`` senses the batch with
    :func:`..parallel.wideband.wideband_sense` (B kernel launches on the card
    when the shape takes the fused path), builds the per-channel features and
    takes one Adam step on the BCE of output 0.  The sensing runs without
    gradient: its outputs are data for the step, as in the reference, where
    the parameters never reach them.  Planes and labels that lie elsewhere
    (numpy included) are moved to ``device`` first."""
    device = torch.device(device)
    taps = torch.from_numpy(cfg.taps()).to(device)

    def init_fn(generator: torch.Generator) -> TrainState:
        params = init_mlp(generator, n_in=4, n_hidden=5, n_out=1).to(device)
        return TrainState(params, make_optimizer(TrainConfig(learning_rate), params), 0)

    def step_fn(state: TrainState, planes, labels) -> tuple[TrainState, torch.Tensor]:
        planes = torch.as_tensor(planes).to(device)
        labels = torch.as_tensor(labels, dtype=torch.float32).to(device)
        with torch.no_grad():
            res = wideband_sense(planes, taps, cfg)
        feats = wideband_features(res["energy"], res["noise"])
        return _descend(state, lambda params: _loss(params, feats, labels))

    return init_fn, step_fn


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
