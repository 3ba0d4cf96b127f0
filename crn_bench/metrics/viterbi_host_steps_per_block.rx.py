"""Add-compare-select and traceback steps that ``viterbi_decode`` drives from
the host per ``StreamReceiver.process`` call: the program's counter
``fec.viterbi_host_steps`` (two per trellis step a call, a batch of frames
sharing them), over the traced window's ``rx.process`` calls that lie inside
the harness's ``process`` spans."""


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
    if not calls:
        return None
    return sum(c["counts"].get("fec.viterbi_host_steps", 0) for c in calls) / len(calls)
