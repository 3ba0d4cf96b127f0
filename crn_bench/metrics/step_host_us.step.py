"""Host us per device stream step: the program's ``rx.step`` span (the
dispatch of one step of ``StreamBank.feed`` or ``StreamReceiver.feed_device``,
planes to queued record), from the program's own records of the steps whose
middle, the host clock mapped onto the trace's, lies inside the traced
window; none where the program has no tracer or no such span."""


def _calls(rec, top: str) -> list:
    """The program's top-level ``top`` calls (``utils/profiling.py``) whose
    middle lies inside the traced window; none where the program has no tracer."""
    try:
        from cognitive_radio_network_tpu_torch.utils.profiling import calls
    except ImportError:
        return []
    lo, hi = rec["window"]
    off = rec["offset_us"]
    return [c for c in calls() if c["name"] == top and lo <= (c["t0"] + c["t1"]) / 2 * 1e6 + off <= hi]


def read(rec):
    steps = _calls(rec, "rx.step")
    if not steps:
        return None
    return sum(c["seconds"]["rx.step"] for c in steps) / len(steps) * 1e6
