"""Collectives along one named mesh axis: the ``jax.lax`` ones the reference uses.

The reference's sharded functions are ``shard_map`` bodies that call
``jax.lax.axis_index``, ``axis_size``, ``ppermute``, ``psum`` and gathers
inside one compiled program.  Here each rank runs the body in its own
process, and each of those calls is an explicit collective on the process
group of the mesh axis (``mesh.get_group(name)``).

Every rank of the axis's group must make the same calls in the same order.
An axis the mesh does not name has size 1: its index is 0, a ring shift along
it returns its input, a sum or a gather is the input itself.

Under the ``gloo`` backend the exchanged tensors travel through host memory:
gloo's point-to-point calls take CPU tensors only, so a CUDA tensor is copied
to the host, exchanged and copied back, explicitly.  These are small: FIR
halos, candidate records, decode windows.  Under ``nccl`` tensors stay on the
card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from cognitive_radio_network_tpu_torch.parallel.mesh import axis_index, axis_size

__all__ = [
    "axis_index",
    "axis_size",
    "ring_shift",
    "psum",
    "all_gather",
    "mesh_mean",
    "mesh_broadcast",
]


def _group(mesh: DeviceMesh, name: str):
    return mesh.get_group(name)


def _staged(x: torch.Tensor, group) -> bool:
    """True when ``x`` must go through host memory for ``group``'s backend."""
    return x.device.type != "cpu" and dist.get_backend(group) == "gloo"


def ring_shift(x: torch.Tensor, mesh: DeviceMesh, name: str, shift: int) -> torch.Tensor:
    """``jax.lax.ppermute`` with the perm ``i -> (i + shift) mod n`` along axis
    ``name`` (``shift`` is +1 or -1): returns the tensor the rank ``shift``
    places behind this one sent.  At axis size 1 it returns ``x`` itself and
    sends nothing."""
    if shift not in (1, -1):
        raise ValueError(f"a ring shift moves one place, got {shift}")
    n = axis_size(mesh, name)
    if n == 1:
        return x
    group = _group(mesh, name)
    i = axis_index(mesh, name)
    dst = dist.get_global_rank(group, (i + shift) % n)
    src = dist.get_global_rank(group, (i - shift) % n)
    staged = _staged(x, group)
    send = (x.cpu() if staged else x).contiguous()
    recv = torch.empty_like(send)
    for req in dist.batch_isend_irecv(
        [dist.P2POp(dist.isend, send, dst, group), dist.P2POp(dist.irecv, recv, src, group)]
    ):
        req.wait()
    return recv.to(x.device) if staged else recv


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise sum over ``group``, as a new tensor on ``x``'s device."""
    staged = _staged(x, group)
    out = x.cpu() if staged else x.clone()  # a new tensor: the caller's is not summed into
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(x.device) if staged else out


def psum(x: torch.Tensor, mesh: DeviceMesh, name: str) -> torch.Tensor:
    """``jax.lax.psum`` along axis ``name``: the elementwise sum over the
    axis's ranks, on every one of them (a new tensor; ``x`` is unchanged)."""
    if axis_size(mesh, name) == 1:
        return x
    return _all_reduce(x, _group(mesh, name))


def _mesh_group(mesh: DeviceMesh):
    """The group of every rank of ``mesh``: the world's, which the mesh must
    span (a collective over a part of the world would need a group made by
    every rank of it)."""
    if mesh.size() != dist.get_world_size():
        raise ValueError(
            f"a collective over the whole mesh needs a mesh over the whole world: the mesh has "
            f"{mesh.size()} ranks, the world {dist.get_world_size()}"
        )
    return dist.group.WORLD


def mesh_mean(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The elementwise mean over every rank of ``mesh``, in one all-reduce
    (made at every mesh size, so a world of one runs its backend's call)."""
    return _all_reduce(x, _mesh_group(mesh)) / mesh.size()


def mesh_broadcast(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The mesh's first rank's ``x`` on every rank of it (a new tensor)."""
    group = _mesh_group(mesh)
    staged = _staged(x, group)
    out = x.cpu() if staged else x.clone()
    dist.broadcast(out, src=int(mesh.mesh.flatten()[0]), group=group)
    return out.to(x.device) if staged else out


def all_gather(x: torch.Tensor, mesh: DeviceMesh, name: str, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` along axis ``name``, concatenated along tensor
    dimension ``dim`` in the axis's order, on every rank (the reference's
    ``out_specs=P(name)`` gathered).  Every rank's ``x`` has the same shape."""
    if axis_size(mesh, name) == 1:
        return x
    group = _group(mesh, name)
    staged = _staged(x, group)
    send = (x.cpu() if staged else x).contiguous()
    parts = [torch.empty_like(send) for _ in range(axis_size(mesh, name))]
    dist.all_gather(parts, send, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if staged else out
