"""Starting the ``torch.distributed`` world: one process per rank.

Port of ``cognitive_radio_network_tpu/parallel/multihost.py``.  The reference
scales across hosts with ``jax.distributed``; here every host runs the same
program in one process per rank, the processes meet at a rendezvous, and the
collectives of :mod:`.collectives` run over process groups.

Usage (every process):

    from cognitive_radio_network_tpu_torch.parallel import multihost
    multihost.initialize()          # torchrun's environment, or a world of one
    mesh = multihost.global_mesh(MeshSpec(time=4, channel=2, data=N // 8))

The backend is explicit: ``nccl`` for CUDA devices unless the caller names
``gloo``, and ``gloo`` for the CPU.  NCCL takes one card per rank, so asking
for it with more ranks on a host than the host has cards raises; ranks that
share a card run ``gloo``, named by the caller.  Nothing switches quietly.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from cognitive_radio_network_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S, MeshSpec, make_mesh

__all__ = ["initialize", "is_distributed", "global_mesh", "host_local_sync"]


def initialize(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    *,
    backend: str | None = None,
    device="cuda",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """``torch.distributed.init_process_group`` with the environment's
    fallbacks; does nothing when the world is already initialized.

    Arguments left out are read from torch's own environment, as ``torchrun``
    sets it (``MASTER_ADDR`` and ``MASTER_PORT`` for an ``env://``
    rendezvous, ``WORLD_SIZE``, ``RANK``).  With neither an ``init_method``
    nor a world size anywhere, the process is a world of one.  On a CUDA
    ``device`` the process takes card ``LOCAL_RANK`` (else its rank) modulo
    the host's cards.  Every collective of the world's groups raises after
    ``timeout_s``."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    if init_method is None and "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        init_method = "env://"
    world_size = world_size if world_size is not None else _int_env("WORLD_SIZE")
    rank = rank if rank is not None else _int_env("RANK")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    store = None
    if init_method is None and world_size is None:
        world_size, rank, store = 1, 0, dist.HashStore()
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"nccl runs on CUDA devices, not {device}")
        cards = torch.cuda.device_count()
        per_host = _int_env("LOCAL_WORLD_SIZE") or world_size or 1
        if per_host > cards:
            raise ValueError(
                f"nccl takes one card per rank: {per_host} ranks on this host, {cards} cards; "
                f"ranks that share a card need backend='gloo'"
            )
    if device.type == "cuda":
        local = _int_env("LOCAL_RANK")
        torch.cuda.set_device((local if local is not None else rank or 0) % torch.cuda.device_count())
    dist.init_process_group(
        backend,
        init_method=init_method,
        store=store,
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def _int_env(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def is_distributed() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def global_mesh(spec: MeshSpec, *, device="cuda"):
    """The mesh over the ranks of every host (the world is global)."""
    return make_mesh(spec, device=device)


def host_local_sync(tag: int = 0) -> None:
    """Barrier across every rank of the world (the start-time broadcast
    analog, src/crts_controller.cpp:487-509); nothing in a world of one.
    ``tag`` names the barrier in the error a failed one raises."""
    if not is_distributed():
        return
    try:
        dist.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"host_local_sync({tag}) failed on rank {dist.get_rank()}") from e
