"""Host us per ``make_wideband_fn`` call inside the program's ``wideband.call``
span, from the program's own records (``utils/profiling.py``) of the calls
whose middle lies in the traced window, where the driver runs nothing but
its loop; its ``wideband.energy``, ``.decide`` and ``.carry`` parts go to
standard error.  The calls are taken by the window and not by the harness's
``wideband_call`` spans, since the profiler keeps only some of those in a
window of ~1,600 calls.  None where the program has no tracer or no such span."""

import sys

PARTS = ("wideband.place", "wideband.energy", "wideband.decide", "wideband.carry")


def _window_calls(rec) -> list:
    """The program's top-level ``wideband.call`` calls whose middle, the host
    clock mapped onto the trace's, lies in the traced window."""
    try:
        from cognitive_radio_network_tpu_torch.utils.profiling import calls
    except ImportError:
        return []
    lo, hi = rec["window"]
    off = rec["offset_us"]
    return [c for c in calls() if c["name"] == "wideband.call"
            and lo <= (c["t0"] + c["t1"]) / 2 * 1e6 + off <= hi]


def read(rec):
    calls = _window_calls(rec)
    if not calls:
        return None
    mean = {k: sum(c["seconds"].get(k, 0.0) for c in calls) / len(calls) * 1e6
            for k in ("wideband.call",) + PARTS}
    counts = {k: sum(c["counts"].get(k, 0) for c in calls) / len(calls)
              for k in ("wideband.cycles", "wideband.carried_streams")}
    print(f"wideband_host_us: {len(calls)} calls; host us a call " +
          ", ".join(f"{k} {v!r}" for k, v in mean.items()) + "; a call's counters " +
          ", ".join(f"{k} {v!r}" for k, v in counts.items()), file=sys.stderr)
    return mean["wideband.call"]
