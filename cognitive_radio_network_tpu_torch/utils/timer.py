"""Timer utilities (a copy of ``cognitive_radio_network_tpu/utils/timer.py``):
the liquid-derived tic/toc helper (src/timer.cc:40-82) on time.monotonic,
plus a latency recorder for the BASELINE p50 block-latency metric.  Host
clocks only: time device work with :mod:`.profiling`."""

from __future__ import annotations

import time

import numpy as np

__all__ = ["Timer", "LatencyRecorder"]


class Timer:
    """tic/toc with the reference's semantics: toc() returns seconds since
    the last tic without resetting."""

    def __init__(self):
        self._t0 = time.monotonic()

    def tic(self) -> None:
        self._t0 = time.monotonic()

    def toc(self) -> float:
        return time.monotonic() - self._t0


class LatencyRecorder:
    """Collects per-operation latencies; reports percentiles + histogram."""

    def __init__(self):
        self.samples: list[float] = []

    def record(self, seconds: float) -> None:
        self.samples.append(seconds)

    def time(self, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        self.record(time.perf_counter() - t0)
        return out

    def percentiles(self, qs=(50, 90, 99)) -> dict[int, float]:
        if not self.samples:
            return {q: float("nan") for q in qs}
        arr = np.asarray(self.samples)
        return {q: float(np.percentile(arr, q)) for q in qs}

    def histogram(self, bins: int = 20):
        counts, edges = np.histogram(self.samples, bins=bins)
        return counts, edges
