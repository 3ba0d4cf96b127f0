"""Share (%) of the accepted frame candidates of the device stream steps that
the step's speculative decode served: the program's counters
``rx.step_accepted`` less ``rx.step_spec_misses`` (accepted candidates whose
PHY header matched no speculated configuration, decoded by the stream's host
fallback), over ``rx.step_accepted``, summed over the ``rx.step_fetch`` reads
inside the traced window; none where no read accepted a candidate or the
program has no such counters."""


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
    accepted = sum(c["counts"].get("rx.step_accepted", 0) for c in reads)
    if not accepted:
        return None
    misses = sum(c["counts"].get("rx.step_spec_misses", 0) for c in reads)
    return 100.0 * (accepted - misses) / accepted
