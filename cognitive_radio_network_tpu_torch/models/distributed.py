"""The wideband sense->classify train and apply steps, on one device or a mesh.

Port of ``cognitive_radio_network_tpu/models/distributed.py``:
:func:`wideband_features`, ``make_sharded_train_step`` and
``make_sharded_apply``.  The classifier is the sigmoid MLP applied per
channel with shared weights over features [noise_floor, E_{k-1}, E_k,
E_{k+1}] (the wideband generalization of CE_Predictive_Node's [NF, CH1, CH2,
CH3] input, CE_Predictive_Node.cpp:200); output 0 is the channel-occupied
probability.

Without a mesh one device holds everything.  With one (:mod:`..parallel.mesh`),
every rank is given the whole batch and takes its block, as the reference's
step takes planes ``P('data', 'time')``: its rows along ``data``, its time
segment along ``time`` (the wideband halo joins the segments), and, of the
labels and outputs, its cycles and its columns along ``channel``.  The
features are built over all M channels before the channel cut, because their
cyclic neighbours need every channel.  Parameters are replicated: broadcast
from the mesh's first rank at ``init_fn``, and after ``backward()`` one
all-reduce averages the gradients over every rank of the mesh.  Each rank
holds an equal share of the batch, so the mean of the local mean losses is
the reference's global mean, and the step returns it on every rank.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from cognitive_radio_network_tpu_torch.models.train import (
    TrainConfig,
    TrainState,
    _bce,
    _descend,
    make_optimizer,
)
from cognitive_radio_network_tpu_torch.parallel.collectives import mesh_broadcast, mesh_mean
from cognitive_radio_network_tpu_torch.parallel.mesh import block, block_range
from cognitive_radio_network_tpu_torch.parallel.wideband import (
    WidebandConfig,
    _sharded_sense,
    wideband_sense,
)
from cognitive_radio_network_tpu_torch.signal.mlp import OccupancyMLP, init_mlp, mlp_forward
from cognitive_radio_network_tpu_torch.utils.device import full_f32

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


def _data_axis(mesh: DeviceMesh | None) -> str | None:
    return "data" if mesh is not None and "data" in (mesh.mesh_dim_names or ()) else None


def _features(planes, taps, cfg: WidebandConfig, mesh: DeviceMesh | None) -> torch.Tensor:
    """Sense ``planes`` (no gradient) and build the per-channel features:
    (B, C, M, 4), or with ``mesh`` this rank's (B/dd, C/dt, M/dc, 4) block,
    cut along ``channel`` after the features are built."""
    with torch.no_grad():
        if mesh is None:
            res = wideband_sense(planes, taps, cfg)
            return wideband_features(res["energy"], res["noise"])
        res = _sharded_sense(planes, taps, cfg, mesh, _data_axis(mesh), None)
        lo, hi = block_range(cfg.num_channels, mesh, "channel")
        return wideband_features(res["energy"], res["noise"])[..., lo:hi, :]


def _descend_mesh(state: TrainState, loss_of, mesh: DeviceMesh) -> tuple[TrainState, torch.Tensor]:
    """One Adam step on the mesh mean of ``loss_of(params)``: the local
    gradients and the local loss averaged by one all-reduce, then the same
    update on every rank.  Everything in full float32, as :func:`_descend`."""
    with full_f32():
        state.opt.zero_grad(set_to_none=True)
        loss = loss_of(state.params)
        loss.backward()
        params = list(state.params.parameters())
        flat = torch.cat([p.grad.reshape(-1) for p in params] + [loss.detach().reshape(1)])
        flat = mesh_mean(flat, mesh)
        offset = 0
        for p in params:
            p.grad.copy_(flat[offset : offset + p.numel()].view_as(p))
            offset += p.numel()
        state.opt.step()
    return TrainState(state.params, state.opt, state.step + 1), flat[-1]


def make_sharded_train_step(
    cfg: WidebandConfig,
    learning_rate: float = 1e-3,
    *,
    mesh: DeviceMesh | None = None,
    device="cuda",
):
    """Returns ``(init_fn, step_fn)`` on ``device`` (the card unless the caller
    asks for the CPU).

    ``init_fn(generator)`` draws a 4-5-1 network and its Adam optimizer (a
    :class:`..models.train.TrainState`); with ``mesh`` the network is the
    mesh's first rank's, broadcast.  ``step_fn(state, planes (B, T*M, 2),
    labels (B, C, M)) -> (state, loss)`` senses the batch with
    :func:`..parallel.wideband.wideband_sense` (one kernel launch a step on
    the card when the shape takes the fused path, the planes read in place;
    with a mesh, one a rank for its block), builds the per-channel features
    and takes one Adam step on
    the BCE of output 0.  The sensing runs without gradient: its outputs are
    data for the step, as in the reference, where the parameters never reach
    them.  Planes and labels that lie elsewhere (numpy included) are moved to
    ``device`` first; with a mesh only the rank's block of them is, and the
    loss is the mean over the whole batch on every rank (the module
    docstring)."""
    device = torch.device(device)
    taps = torch.from_numpy(cfg.taps()).to(device)

    def init_fn(generator: torch.Generator) -> TrainState:
        params = init_mlp(generator, n_in=4, n_hidden=5, n_out=1).to(device)
        if mesh is not None:
            with torch.no_grad():
                for p in params.parameters():
                    p.copy_(mesh_broadcast(p.detach(), mesh))
        return TrainState(params, make_optimizer(TrainConfig(learning_rate), params), 0)

    def step_fn(state: TrainState, planes, labels) -> tuple[TrainState, torch.Tensor]:
        if mesh is None:
            planes = torch.as_tensor(planes).to(device)
            labels = torch.as_tensor(labels, dtype=torch.float32).to(device)
            feats = _features(planes, taps, cfg, None)
            return _descend(state, lambda params: _loss(params, feats, labels))
        spec = (_data_axis(mesh), "time", "channel")
        labels = block(torch.as_tensor(labels, dtype=torch.float32), mesh, spec, device)
        feats = _features(planes, taps, cfg, mesh)
        return _descend_mesh(state, lambda params: _loss(params, feats, labels), mesh)

    return init_fn, step_fn


def make_sharded_apply(cfg: WidebandConfig, *, mesh: DeviceMesh | None = None, device="cuda"):
    """Inference over a batch of streams: ``apply_fn(params, planes)`` with
    planes (B, T*M, 2) -> occupancy probabilities (B, C, M).

    Taps live on ``device`` (the card unless the caller asks for the CPU),
    and planes given as numpy or on another device are moved there.
    ``params`` is a 4-n-1 :class:`..signal.mlp.OccupancyMLP` on the same
    device.  The batch is sensed by one kernel launch a call on the card (the
    planes read in place).  With ``mesh`` every rank is given the whole batch,
    moves only its block to ``device`` and returns its (B/dd, C/dt, M/dc)
    block of the probabilities, one launch a rank."""
    device = torch.device(device)
    taps = torch.from_numpy(cfg.taps()).to(device)

    @torch.no_grad()
    def apply_fn(params: OccupancyMLP, planes) -> torch.Tensor:
        if mesh is None:
            planes = torch.as_tensor(planes).to(device)
        feats = _features(planes, taps, cfg, mesh)
        return mlp_forward(params, torch.log1p(feats * 1e3))[..., 0]

    return apply_fn
