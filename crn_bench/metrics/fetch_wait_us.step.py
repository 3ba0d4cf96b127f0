"""Host us per device stream step in its read: the program's ``rx.step_fetch``
span (the wait for the step's group of records in pinned memory and the
unpacking of every stream's frames, with any fallback decode inside it), from
the program's own records of the reads whose middle lies inside the traced
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
    reads = _calls(rec, "rx.step_fetch")
    if not reads:
        return None
    return sum(c["seconds"]["rx.step_fetch"] for c in reads) / len(reads) * 1e6
