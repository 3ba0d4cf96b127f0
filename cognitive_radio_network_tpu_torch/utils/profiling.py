"""Profiling helpers (port of ``cognitive_radio_network_tpu/utils/profiling.py``)
and the program's tracer.

The reference has no tracing (SURVEY.md §5); the rebuild needs it for the
BASELINE latency metrics.  :func:`trace` records host and card activity with
``torch.profiler`` and writes a Chrome trace; :func:`device_time` times a
function on the device its outputs live on: by CUDA events on a card (the
host returns before the card finishes, so a host clock alone would time the
enqueue), by the host clock on the CPU; :func:`drain` waits for the devices
a result lives on.

The tracer: :func:`span` and :func:`count` mark the program's layer
boundaries (the sense call, the stream receiver's stages, the Viterbi loop).
They record only while a torch profiler records or inside
:func:`recording`; otherwise each reads the module's flag and the
profiler's and returns (``span`` a shared no-op), with no clock read, no
record and no ``record_function``.  A span's record holds its name, its start and end on
``time.perf_counter``, the index of its parent span on the same thread, a
call id (the index of its thread's outermost open span: every span of one
top-level call shares it) and the counters :func:`count` added while it was
the innermost open span (none inside :func:`uncounted`, which a CUDA graph's
capture runs in).  Records go to a bounded ring that drops the oldest
first and counts what it dropped (:func:`recorded`, :func:`dropped`,
:func:`calls`).  While a profiler records, each span is also a
``record_function`` range of the same name, so it lies on the trace's clock
and the device operations it launched join it by correlation id.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import threading
import time
from pathlib import Path

import torch

__all__ = ["trace", "device_time", "drain", "span", "count", "uncounted", "recording", "recorded",
           "dropped", "calls"]

RING = 1 << 17  # records the ring keeps before it drops the oldest


class _PublicFlag:
    """The profiler's state through the public call, where the module flag is gone."""

    @property
    def _is_profiler_enabled(self) -> bool:
        return torch.autograd._profiler_enabled()


_profiler = (torch.autograd.profiler if hasattr(torch.autograd.profiler, "_is_profiler_enabled")
             else _PublicFlag())
_recording = 0  # recording() blocks open, in any thread


class _Off:
    """The shared no-op span.  Its enter and exit are C calls, where
    ``contextlib.nullcontext``'s are Python ones (on an H100 host a span off
    took 0.20 us this way, 0.40 us with ``nullcontext``):
    ``type.__prepare__`` takes any arguments and returns a new empty dict,
    which is false, so an exception raised in the block propagates."""

    __slots__ = ()
    __enter__ = __exit__ = type.__prepare__


_OFF = _Off()
_ring: collections.deque = collections.deque(maxlen=RING)
_dropped = 0
_lock = threading.Lock()
_index = itertools.count()
_local = threading.local()


def _stack() -> list:
    """This thread's open spans' records, outermost first."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _new(name: str, stack: list, t0: float) -> dict:
    index = next(_index)
    parent = stack[-1] if stack else None
    return {"name": name, "index": index, "parent": None if parent is None else parent["index"],
            "call": index if parent is None else parent["call"], "t0": t0, "t1": None, "counts": {}}


def _keep(rec: dict) -> None:
    global _dropped
    with _lock:
        if len(_ring) == _ring.maxlen:
            _dropped += 1
        _ring.append(rec)


class _Span:
    __slots__ = ("name", "rec", "rf")

    def __init__(self, name: str):
        self.name = name

    # the record's times take in the span's own range on the trace, so the
    # profiler's cost of a span falls within it and not in its parent's gaps
    def __enter__(self) -> dict:
        t0 = time.perf_counter()
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        stack = _stack()
        self.rec = _new(self.name, stack, t0)
        stack.append(self.rec)
        return self.rec

    def __exit__(self, *exc) -> bool:
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.rec["t1"] = time.perf_counter()
        _stack().pop()
        _keep(self.rec)
        return False


def span(name: str):
    """A context manager that records the block as the span ``name`` (see
    the module's docstring); a shared no-op while nothing records."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open span; with no
    span open, record a span of no length that holds the count.  Does
    nothing while nothing records."""
    if not (_recording or _profiler._is_profiler_enabled):
        return
    stack = _stack()
    if stack:
        counts = stack[-1]["counts"]
        counts[name] = counts.get(name, 0) + n
        return
    rec = _new(name, stack, time.perf_counter())
    rec["t1"] = rec["t0"]
    rec["counts"][name] = n
    _keep(rec)


@contextlib.contextmanager
def uncounted():
    """Keep what :func:`count` adds inside the block, on this thread, out of
    every span: for work that runs nothing, as the capture of a CUDA graph,
    whose replays count for themselves.  Spans opened in the block record as
    ever."""
    stack = _stack()
    stack.append(dict(stack[-1], counts={}) if stack else {"index": None, "call": None, "counts": {}})
    try:
        yield
    finally:
        stack.pop()


def recorded() -> list[dict]:
    """The ring's records (closed spans), in the order they opened."""
    with _lock:
        return sorted(_ring, key=lambda r: r["index"])


def dropped() -> int:
    """Records the ring has dropped to keep its bound, since the process began."""
    return _dropped


@contextlib.contextmanager
def recording():
    """Record spans and counts inside the block with no profiler running.
    Yields a list that holds the block's records once the block has closed."""
    global _recording
    first = next(_index)
    with _lock:
        _recording += 1
    out: list[dict] = []
    try:
        yield out
    finally:
        with _lock:
            _recording -= 1
        out.extend(r for r in recorded() if r["index"] > first)


def calls(records: list[dict] | None = None) -> list[dict]:
    """The records (the ring's by default) grouped by top-level call, in the
    order the calls began: per call its top-level span's ``name``, ``t0`` and
    ``t1``, ``seconds`` (host seconds summed by span name over the call's
    spans, the top-level one included) and ``counts`` (its counters summed).
    A call whose top-level record is not among the records is left out."""
    records = recorded() if records is None else records
    out: dict[int, dict] = {}
    for r in records:
        if r["index"] == r["call"]:
            out[r["call"]] = {"name": r["name"], "t0": r["t0"], "t1": r["t1"], "seconds": {}, "counts": {}}
    for r in records:
        c = out.get(r["call"])
        if c is None:
            continue
        c["seconds"][r["name"]] = c["seconds"].get(r["name"], 0.0) + (r["t1"] - r["t0"])
        for k, v in r["counts"].items():
            c["counts"][k] = c["counts"].get(k, 0) + v
    return sorted(out.values(), key=lambda c: c["t0"])


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
    chrome://tracing or Perfetto), and the program's spans recorded in the
    block beside it, ``<log_dir>/program_spans.json`` (``records`` and the
    ring's ``dropped`` count; times on ``time.perf_counter``).  Yields the
    profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    path = Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    first = next(_index)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(path / "trace.json"))
    mine = [r for r in recorded() if r["index"] > first]
    (path / "program_spans.json").write_text(json.dumps({"dropped": dropped(), "records": mine}))


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
