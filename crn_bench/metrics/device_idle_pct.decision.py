"""Idle share (%) of the device while a quiet period is being served: over
the intervals from each quiet period's first due time to its last decision
on the host (the host clock mapped onto the trace's)."""

from crn_bench.harness import idle_pct


def read(rec):
    off = rec["offset_us"]
    lo, hi = rec["window"]
    windows = [(max(a * 1e6 + off, lo), min(b * 1e6 + off, hi)) for a, b in rec["counters"]["bursts"]]
    windows = [(a, b) for a, b in windows if b > a]
    return idle_pct(rec, windows) if windows else None
