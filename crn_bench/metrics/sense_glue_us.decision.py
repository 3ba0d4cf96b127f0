"""Host us per ``make_sense_fn`` call of the quiet-period server outside its
uploads and its dispatch: the program's ``sense.call`` less its
``sense.upload`` and ``sense.classify`` time (placement's and preparation's
own Python), from the program's own records of the traced window's calls
that lie inside the harness's ``sense_call`` spans."""


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
    calls = _calls(rec, "sense_call", "sense.call")
    if not calls:
        return None
    s = [c["seconds"] for c in calls]
    return sum(d["sense.call"] - d.get("sense.upload", 0.0) - d.get("sense.classify", 0.0)
               for d in s) / len(s) * 1e6
