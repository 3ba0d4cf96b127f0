"""Profiling helpers (port of ``cognitive_radio_network_tpu/utils/profiling.py``).

The reference has no tracing (SURVEY.md §5); the rebuild needs it for the
BASELINE latency metrics.  :func:`trace` records host and card activity with
``torch.profiler`` and writes a Chrome trace; :func:`device_time` times a
function on the device its outputs live on: by CUDA events on a card (the
host returns before the card finishes, so a host clock alone would time the
enqueue), by the host clock on the CPU; :func:`drain` waits for the devices
a result lives on.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch

__all__ = ["trace", "device_time", "drain"]


def _tensors(tree):
    """The tensors of a tensor, or of a (nested) tuple, list or dict of them."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


@contextlib.contextmanager
def trace(log_dir: str | Path = "traces"):
    """Record host and (when there is one) card activity inside the block and
    write it as a Chrome trace, ``<log_dir>/trace.json`` (open it in
    chrome://tracing or Perfetto).  Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    path = Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(path / "trace.json"))


def drain(tree) -> None:
    """Wait until the work that produced ``tree`` (a tensor, or a nested
    tuple, list or dict of them) is done: synchronize each CUDA device its
    tensors live on.  CPU tensors are done when they are returned."""
    for dev in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def device_time(fn, *args, reps: int = 16, warmup: int = 2) -> dict:
    """Time ``fn(*args)`` over ``reps`` calls issued back to back.

    Returns {"mean_s", "p50_s", "total_s", "reps"}, the reference's keys:
    with outputs on a card (or, with no warm-up, inputs), ``total_s`` is the
    CUDA-event time from before the first call to after the last on the
    current stream; otherwise the host clock around the calls.  ``p50_s`` equals ``mean_s``, as in the
    reference: the calls are timed together, not one by one."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
        drain(out)
    # where the work runs: the warm-up's outputs, or with no warm-up the inputs
    probe = out if warmup else args
    cuda = any(t.device.type == "cuda" for t in _tensors(probe))
    if cuda:
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    if cuda:
        stop.record()
        stop.synchronize()
        total = start.elapsed_time(stop) / 1e3
    else:
        drain(out)
        total = time.perf_counter() - t0
    return {"mean_s": total / reps, "p50_s": total / reps, "total_s": total, "reps": reps}
