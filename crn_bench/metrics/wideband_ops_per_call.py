"""Device operations (kernels, copies, sets) launched inside the program's
``wideband.call`` spans (``make_wideband_fn``'s call, ``utils/profiling.py``),
counted per call in the trace and averaged over the calls whose device
records the profiler kept; none where the program has no such span."""

from crn_bench.harness import span_ops


def read(rec):
    counts = [len(ops) for ops in span_ops(rec, "wideband.call") if ops]
    return sum(counts) / len(counts) if counts else None
