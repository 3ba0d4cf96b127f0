"""Share (%) of the receiver's candidates that went to decode: the program's
counters ``rx.candidates_accepted`` over ``rx.candidates_attempted`` (a peak
at or above the threshold, outside a frame already accepted), summed over
the traced window's ``rx.process`` calls that lie inside the harness's
``process`` spans; none where no candidate was attempted."""


def _calls(rec, label: str, top: str) -> list:
    """The program's top-level ``top`` calls (``utils/profiling.py``) whose
    middle, the host clock mapped onto the trace's, lies inside one of the
    harness's ``label`` spans of the traced window; none where the program
    has no tracer."""
    try:
        from cognitive_radio_network_tpu_torch.utils.profiling import calls
    except ImportError:
        return []
    off = rec["offset_us"]
    inside = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in rec["events"]
              if e.get("cat") == "user_annotation" and e["name"] == label]
    return [c for c in calls() if c["name"] == top
            and any(a <= (c["t0"] + c["t1"]) / 2 * 1e6 + off <= b for a, b in inside)]


def read(rec):
    calls = _calls(rec, "process", "rx.process")
    tried = sum(c["counts"].get("rx.candidates_attempted", 0) for c in calls)
    if not tried:
        return None
    return 100.0 * sum(c["counts"].get("rx.candidates_accepted", 0) for c in calls) / tried
