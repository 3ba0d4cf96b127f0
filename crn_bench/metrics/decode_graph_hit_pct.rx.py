"""Share (%) of the receiver's decoded frame groups replayed from a CUDA
graph: the program's counter ``rx.decode_graph_replays`` over it plus
``rx.decode_graph_captures`` and ``rx.decode_graph_eager`` (groups decoded
eagerly on the card), summed over the traced window's ``rx.process`` calls
that lie inside the harness's ``process`` spans; none where those calls count
none of the three, as on the CPU or in a program without decode graphs."""

COUNTERS = ("rx.decode_graph_replays", "rx.decode_graph_captures", "rx.decode_graph_eager")


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
    counts = [c["counts"] for c in _calls(rec, "process", "rx.process")]
    groups = sum(c.get(k, 0) for c in counts for k in COUNTERS)
    if not groups:
        return None
    return 100.0 * sum(c.get("rx.decode_graph_replays", 0) for c in counts) / groups
