"""Overlap-save halo exchange along a mesh axis (a ring shift).

Port of ``cognitive_radio_network_tpu/parallel/halo.py``.  Each time shard
processes a contiguous segment of the IQ stream; the FIR filter needs the last
``halo`` phase rows of the *previous* segment, which flow to the right
between ring neighbours (:func:`.collectives.ring_shift`).  Shard 0 receives
zeros: the stream starts from rest.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from cognitive_radio_network_tpu_torch.parallel.collectives import axis_index, ring_shift
from cognitive_radio_network_tpu_torch.parallel.mesh import block
from cognitive_radio_network_tpu_torch.signal.channelizer import channelize_planes

__all__ = ["halo_exchange", "left_tail", "sharded_channelize"]


def halo_exchange(
    x: torch.Tensor, halo: int, mesh: DeviceMesh, axis_name: str, *, axis: int = 0
) -> torch.Tensor:
    """Prepend this rank's block with the previous shard's tail.

    x: this rank's block; ``axis`` is its streaming dimension.  Sends the
    trailing ``halo`` slices to the right ring neighbour; shard 0 receives
    zeros (stream start: an FIR starting from rest), not the last shard's
    tail that the ring brings round.  Returns x extended by ``halo`` along
    ``axis``."""
    axis = axis % x.dim()
    return torch.cat([left_tail(x, halo, mesh, axis_name, axis=axis), x], dim=axis)


def left_tail(
    x: torch.Tensor, halo: int, mesh: DeviceMesh, axis_name: str, *, axis: int = 0
) -> torch.Tensor:
    """The halo alone: the last ``halo`` slices (along ``axis``) of the left
    ring neighbour's block, zeros on shard 0."""
    axis = axis % x.dim()
    if not 0 < halo <= x.shape[axis]:
        raise ValueError(f"halo {halo} must be in [1, {x.shape[axis]}], the block's length")
    tail = x.narrow(axis, x.shape[axis] - halo, halo)
    from_left = ring_shift(tail, mesh, axis_name, +1)
    if axis_index(mesh, axis_name) == 0:
        return torch.zeros_like(tail)
    return from_left


def sharded_channelize(
    planes,
    taps,
    mesh: DeviceMesh,
    *,
    time_axis: str = "time",
    batch_axis: str | None = None,
    precision: str = "high",
) -> torch.Tensor:
    """Time-sharded polyphase channelizer with the halo exchange.

    planes: the whole (T*M, 2) wide stream, or a (B, T*M, 2) batch, on every
    rank; this rank reads its segment along ``time_axis`` (and, with
    ``batch_axis``, its rows of the batch).  Returns this rank's block of the
    (..., T, M, 2) channelized planes."""
    planes = torch.as_tensor(planes)
    taps = torch.as_tensor(taps, dtype=torch.float32, device=planes.device)
    p, m = taps.shape
    spec = (batch_axis, time_axis) if planes.dim() == 3 else (time_axis,)
    local = block(planes, mesh, spec)
    if local.shape[-2] % m:
        raise ValueError(f"a shard of {local.shape[-2]} wide samples does not hold whole rows of {m}")
    xp = local.reshape(*local.shape[:-2], -1, m, 2)
    t_dim = xp.dim() - 3  # the phase-row (time) axis
    hist = left_tail(xp.float(), p - 1, mesh, time_axis, axis=t_dim)
    return channelize_planes(local, taps, history=hist, precision=precision)
