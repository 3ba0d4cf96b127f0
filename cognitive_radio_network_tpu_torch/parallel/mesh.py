"""Mesh construction over the ranks of a ``torch.distributed`` world.

Port of ``cognitive_radio_network_tpu/parallel/mesh.py``.  The reference
lays its sharded functions over a ``jax.sharding.Mesh`` of devices; here one
process per rank holds one device, and a
``torch.distributed.device_mesh.DeviceMesh`` names the same axes, ``time``,
``channel`` and ``data``, with one process group per axis for its
collectives (:mod:`.collectives`).

:func:`block` cuts one rank's block out of a whole array: the functions of
this package that take a mesh are given the same whole input on every rank,
as the reference's functions are given a global array, and each rank reads
only its own block of it.
"""

from __future__ import annotations

import dataclasses
import datetime

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["MeshSpec", "make_mesh", "axis_index", "axis_size", "block", "block_range"]

AXES = ("time", "channel", "data")
DEFAULT_TIMEOUT_S = 300.0  # every group's collectives raise after this long


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Named mesh axes for the framework's parallelism styles.

    time     time-block data parallelism over the IQ stream (overlap-save
             halo between neighbours — the sequence/context-parallel analog)
    channel  channel parallelism across polyphase channels (the TP analog)
    data     batch parallelism for classifier training
    """

    time: int = 1
    channel: int = 1
    data: int = 1

    @property
    def total(self) -> int:
        return self.time * self.channel * self.data


def make_mesh(
    spec: MeshSpec, *, device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S
) -> DeviceMesh | None:
    """A ``DeviceMesh`` over the first ``spec.total`` ranks of the initialised
    world, row-major in the order (time, channel, data).  It names only the
    axes larger than 1, and is a ``("time",)`` mesh of size 1 when none is.

    Every rank of the world must call it: each axis's groups are made by
    ``new_group``, a collective, each with ``timeout_s``.  A rank beyond
    ``spec.total`` gets None.  Raises ValueError when ``spec.total`` exceeds
    the world size."""
    world = dist.get_world_size()
    if spec.total > world:
        raise ValueError(f"mesh {spec} needs {spec.total} ranks, the world has {world}")
    names = [name for name in AXES if getattr(spec, name) > 1] or ["time"]
    sizes = [getattr(spec, name) for name in names]
    ranks = torch.arange(int(np.prod(sizes)), dtype=torch.int).reshape(sizes)
    me = dist.get_rank()
    timeout = datetime.timedelta(seconds=timeout_s)
    groups = []
    for d in range(len(names)):
        mine = None
        for row in ranks.movedim(d, -1).reshape(-1, sizes[d]).tolist():
            group = dist.new_group(row, timeout=timeout)
            if me in row:
                mine = group
        groups.append(mine)
    if me >= ranks.numel():
        return None
    device_type = torch.device(device).type
    if len(groups) == 1:
        return DeviceMesh.from_group(groups[0], device_type, mesh_dim_names=tuple(names))
    return DeviceMesh.from_group(groups, device_type, mesh=ranks, mesh_dim_names=tuple(names))


def axis_size(mesh: DeviceMesh, name: str | None) -> int:
    """The size of mesh axis ``name``; 1 for an axis the mesh does not name
    (the reference's specs leave such an axis out: no sharding along it)."""
    if name is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_index(mesh: DeviceMesh, name: str | None) -> int:
    """This rank's coordinate along axis ``name`` (``jax.lax.axis_index``);
    0 for an axis the mesh does not name."""
    if name is None or name not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(name)


def block_range(n: int, mesh: DeviceMesh, name: str | None) -> tuple[int, int]:
    """[lo, hi) of this rank's equal block of a length-``n`` dimension split
    along axis ``name``; raises ValueError unless the axis size divides n."""
    d = axis_size(mesh, name)
    if n % d:
        raise ValueError(f"length {n} does not split into {d} equal blocks along {name!r}")
    i = axis_index(mesh, name)
    return i * n // d, (i + 1) * n // d


def block(x, mesh: DeviceMesh, spec: tuple, device=None) -> torch.Tensor:
    """This rank's block of the whole array ``x`` (a tensor or a numpy array):
    leading dimension ``j`` is split along mesh axis ``spec[j]`` (None: not
    split), as a ``PartitionSpec`` places a global array.  The block is a view
    of ``x``; with ``device`` it is then moved there, so host input moves only
    the block."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    index = tuple(slice(*block_range(x.shape[j], mesh, name)) for j, name in enumerate(spec))
    out = x[index]
    return out if device is None else out.to(device)
