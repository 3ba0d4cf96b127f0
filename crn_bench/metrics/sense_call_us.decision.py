"""Host us per ``make_sense_fn`` call in the quiet-period server: the mean of
the harness's ``sense_call`` spans (the call's Python, the upload of the
turn's planes and the launch; the decisions' read is a span of its own),
from the untraced window, so the profiler's cost is left out."""


def read(rec):
    d = [t1 - t0 for name, t0, t1 in rec["spans"] if name == "sense_call"]
    return sum(d) / len(d) * 1e6 if d else None
