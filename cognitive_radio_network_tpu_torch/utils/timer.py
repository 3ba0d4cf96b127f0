"""Timer utilities (from ``cognitive_radio_network_tpu/utils/timer.py``):
the liquid-derived tic/toc helper (src/timer.cc:40-82) on time.monotonic.
Host clocks only: time device work with :mod:`.profiling`."""

from __future__ import annotations

import time

__all__ = ["Timer"]


class Timer:
    """tic/toc with the reference's semantics: toc() returns seconds since
    the last tic without resetting."""

    def __init__(self):
        self._t0 = time.monotonic()

    def tic(self) -> None:
        self._t0 = time.monotonic()

    def toc(self) -> float:
        return time.monotonic() - self._t0
