"""Run one function on N local ranks, each in its own process.

The counterpart of ``tests/multihost_worker.py`` and its fleet launcher in
``tests/test_multihost.py``, as a library call:

    results = run_ranks(fn, world=4, backend="gloo", device="cpu", args=(...))

Each rank is a fresh process made with the ``spawn`` start method (a process
that has touched CUDA must never fork).  The ranks meet through a ``file://``
store in a new temporary directory, so concurrent callers never share a port.
A rank on ``device="cuda"`` takes card ``rank % device_count``.  Each rank
calls ``fn(*args)`` inside ``full_f32()`` (float32 matmuls and convolutions
without TF32, as the one-device entry points compute) and its return value
comes back in rank order.  ``fn`` must be importable by name (a module's
top-level function) and return host data (numbers, numpy arrays, CPU
tensors).

A rank that raises makes the call raise with that rank's traceback, and the
other ranks are ended; so does a rank that exits without a result, and a
call that passes ``timeout_s``.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from cognitive_radio_network_tpu_torch.parallel import multihost
from cognitive_radio_network_tpu_torch.utils.device import full_f32

__all__ = ["run_ranks"]


_GRACE_S = 3.0  # after a first failure, how long other ranks' reports are awaited


def _rank_main(fn, rank, world, init_method, backend, device, args, timeout_s, results) -> None:
    try:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        multihost.initialize(
            init_method, world, rank, backend=backend, device=device, timeout_s=timeout_s
        )
        with full_f32():
            results.put(("ok", rank, fn(*args)))
    except BaseException:
        results.put(("error", rank, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(
    fn,
    world: int,
    *,
    backend: str | None = None,
    device="cuda",
    args: tuple = (),
    timeout_s: float = 600.0,
) -> list:
    """``[fn(*args) on rank r for r in range(world)]``, each rank in its own
    process of a ``world``-rank ``torch.distributed`` world on ``backend``
    (:func:`.multihost.initialize`'s default when None: ``nccl`` on CUDA,
    ``gloo`` on the CPU).  Raises RuntimeError with a failed rank's
    traceback, or TimeoutError after ``timeout_s``; no rank outlives the
    call."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="crn_ranks_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [
        ctx.Process(
            target=_rank_main,
            args=(fn, rank, world, init_method, backend, str(device), args, timeout_s, results),
            daemon=True,
        )
        for rank in range(world)
    ]
    out: list = [None] * world
    done = [False] * world
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while not all(done):
            left = deadline - time.monotonic()
            if left <= 0:
                missing = [r for r in range(world) if not done[r]]
                raise TimeoutError(f"ranks {missing} of {world} gave no result in {timeout_s} s")
            try:
                status, rank, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                # a rank's result is flushed before it exits, so one that has
                # exited and sent nothing within the wait above never will
                dead = [r for r, p in enumerate(procs) if not done[r] and p.exitcode is not None]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} of {world} exited with code {procs[dead[0]].exitcode} "
                        f"and no result"
                    ) from None
                continue
            if status == "error":
                raise RuntimeError(_failures(results, rank, value, world))
            out[rank], done[rank] = value, True
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is None:  # never started
                continue
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _failures(results, rank: int, trace: str, world: int) -> str:
    """The first failed rank's traceback and those of the ranks that fail
    within a short grace after it: a rank that raises makes its peers fail in
    their next collective, and its own report may arrive after theirs."""
    lines = [f"rank {rank} of {world} failed:\n{trace}"]
    deadline = time.monotonic() + _GRACE_S
    while (left := deadline - time.monotonic()) > 0:
        try:
            status, other, value = results.get(timeout=left)
        except queue.Empty:
            break
        if status == "error":
            lines.append(f"rank {other} of {world} failed:\n{value}")
    return "\n".join(lines)
