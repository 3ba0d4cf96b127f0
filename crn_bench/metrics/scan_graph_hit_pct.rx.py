"""Share (%) of the receiver's block scans replayed from a CUDA graph: the
program's counter ``rx.scan_graph_replays`` summed over the traced window's
``rx.process`` calls that lie inside the harness's ``process`` spans, over
those calls that opened ``rx.scan``; none where no call scanned, or where the
program counts neither replays nor captures (``rx.scan_graph_captures``), as
a program without scan graphs does."""

COUNTERS = ("rx.scan_graph_replays", "rx.scan_graph_captures")


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
    scans = [c for c in _calls(rec, "process", "rx.process") if "rx.scan" in c["seconds"]]
    if not any(k in c["counts"] for c in scans for k in COUNTERS):
        return None
    return 100.0 * sum(c["counts"].get("rx.scan_graph_replays", 0) for c in scans) / len(scans)
