"""Device operations launched inside the program's ``rx.step`` span (one
device stream step of ``StreamBank.feed`` or ``StreamReceiver.feed_device``,
from the blocks' planes to the queued record) per step, counted per span in
the trace of the traced window and averaged over the spans whose device
records the profiler kept; none where the program has no such span.  A
bank's step launches the same work at any number of streams, so this stays
flat as B grows."""

from crn_bench.harness import span_ops


def read(rec):
    counts = [len(ops) for ops in span_ops(rec, "rx.step") if ops]
    return sum(counts) / len(counts) if counts else None
