"""Occupancy-classifier training (port of ``cognitive_radio_network_tpu/models/train.py``).

The reference trained its 4-5-3 MLP *offline* on ~400 labeled feature
examples and pasted the weights into C++ source (README.md:104,
CE_Predictive_Node.cpp:74-121).  Here training is a pipeline on one device:

    IQ scenes (synthetic env)
      -> fused sense front-end (FFT + band features)   [models.sense: one
                                                        sense kernel launch
                                                        for the whole dataset]
      -> sigmoid MLP, per-channel BCE                  [signal.mlp]
      -> Adam with optax.adam's defaults and update rule

The dataset is tiny, so every step is full-batch.  The losses stay on the
device until the loop ends: no call inside :func:`fit`'s loop waits for the
card.  The MLP is the only thing with parameters; the kernel's features are
data, so no kernel output needs a gradient.  Checkpoints go through
:mod:`..io.checkpoint` (``save_state``/``load_state`` in the reference's key
layout).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.env.scene import SceneConfig, synthesize_scene
from cognitive_radio_network_tpu_torch.models.sense import SenseConfig, sense_classify
from cognitive_radio_network_tpu_torch.signal.mlp import OccupancyMLP, init_mlp, mlp_forward
from cognitive_radio_network_tpu_torch.utils.device import full_f32, require_device

__all__ = ["TrainConfig", "TrainState", "make_dataset", "make_optimizer", "train_step", "fit"]

_EPS = 1e-7  # the BCE's probability clip (ref models/train.py:95)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-3
    num_steps: int = 2000
    batch_size: int = 128
    feature_scale: float = 1.0  # features are raw squared-amplitude sums
    log_features: bool = True  # compress dynamic range before the MLP


class TrainState(NamedTuple):
    """The network, its Adam optimizer (which holds the moments and their
    step count) and the number of steps taken.  A step updates ``params``
    and ``opt`` in place and returns the state with ``step`` advanced."""

    params: OccupancyMLP
    opt: torch.optim.Optimizer
    step: int


def make_dataset(
    generator: torch.Generator,
    num_examples: int = 400,
    cfg: SenseConfig = SenseConfig(),
    scene_cfg: SceneConfig | None = None,
    signal_power: float = 0.05,
    power_jitter_decades: float = 1.5,
    *,
    device="cuda",
):
    """Labeled (features (N, 4), occupancy (N, K)) pairs from synthetic scenes,
    made on ``device`` (the card unless the caller asks for the CPU) with
    ``generator``, which must live there.

    Default size mirrors the reference's ~400-example dataset (README.md:104).
    Each channel is occupied with probability 0.35, independently (multi-label:
    idle, single- and multi-channel cycles).  Signal power is
    ``signal_power * 10**U(-j, j)`` with j = ``power_jitter_decades``, one draw
    per example, so the detector generalizes across link gains; 0.0 fixes it.
    The features of the whole dataset come from one ``sense_classify`` call:
    one launch of the sense kernel on the card.
    """
    device = require_device(device)
    scene_cfg = scene_cfg or SceneConfig()
    k = len(scene_cfg.channels_hz)
    occupancy = (torch.rand(num_examples, k, generator=generator, device=device) < 0.35).float()
    u = torch.rand(num_examples, 1, generator=generator, device=device)
    jitter = 10.0 ** ((2.0 * u - 1.0) * power_jitter_decades)
    powers = occupancy * signal_power * jitter
    planes = synthesize_scene(generator, powers, cfg.samples_per_cycle, scene_cfg, as_planes=True)
    # the network is irrelevant: only the features are kept
    res = sense_classify((planes[..., 0], planes[..., 1]), OccupancyMLP(device=device), cfg)
    return res["features"], occupancy


def _bce(p: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of clipped probabilities.  Written out, not
    ``F.binary_cross_entropy``, which clamps the log at -100 instead."""
    p = p.clamp(_EPS, 1 - _EPS)
    return -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p)).mean()


def _loss_fn(params: OccupancyMLP, feats, labels, tcfg: TrainConfig) -> torch.Tensor:
    x = torch.log1p(feats / tcfg.feature_scale) if tcfg.log_features else feats
    return _bce(mlp_forward(params, x), labels)


def make_optimizer(tcfg: TrainConfig, params: OccupancyMLP) -> torch.optim.Adam:
    """``optax.adam(tcfg.learning_rate)`` over ``params``: the same defaults and
    the same update, ``-lr * m_hat / (sqrt(v_hat) + eps)``."""
    return torch.optim.Adam(
        params.parameters(), lr=tcfg.learning_rate, betas=(0.9, 0.999), eps=1e-8
    )


def _descend(state: TrainState, loss_of) -> tuple[TrainState, torch.Tensor]:
    """One Adam step on ``loss_of(params)``.  Forward and backward both run in
    full float32: the backward's matmuls run after the forward's own
    ``full_f32`` block has exited, under whatever the caller set."""
    with full_f32():
        state.opt.zero_grad(set_to_none=True)
        loss = loss_of(state.params)
        loss.backward()
        state.opt.step()
    return TrainState(state.params, state.opt, state.step + 1), loss.detach()


def train_step(state: TrainState, feats, labels, tcfg: TrainConfig) -> tuple:
    """One full-batch step: ``(state, loss)``, the loss a 0-d device tensor."""
    return _descend(state, lambda params: _loss_fn(params, feats, labels, tcfg))


def fit(
    generator: torch.Generator,
    feats,
    labels,
    tcfg: TrainConfig = TrainConfig(),
    params: OccupancyMLP | None = None,
    *,
    device="cuda",
):
    """Full-batch training loop on ``device``; returns (params, losses (num_steps,)).

    Without ``params`` a fresh 4-5-3 network is drawn from ``generator``;
    given ones are copied, never trained in place.  ``feats`` and ``labels``
    (tensors or numpy) are moved to ``device`` once.  The reference reads each
    step's loss back as it goes; here they are read once, after the loop."""
    device = require_device(device)
    feats = torch.as_tensor(feats, dtype=torch.float32).to(device)
    labels = torch.as_tensor(labels, dtype=torch.float32).to(device)
    params = init_mlp(generator) if params is None else copy.deepcopy(params)
    params = params.to(device)
    state = TrainState(params, make_optimizer(tcfg, params), 0)
    losses = []
    for _ in range(tcfg.num_steps):
        state, loss = train_step(state, feats, labels, tcfg)
        losses.append(loss)
    out = torch.stack(losses).cpu().numpy() if losses else np.zeros(0, np.float32)
    return state.params, out
