"""Device operations (kernels, copies, sets) launched per
``StreamReceiver.process`` call, counted per call in the trace and averaged
over the calls whose device records the profiler kept."""

from crn_bench.harness import span_ops


def read(rec):
    counts = [len(ops) for ops in span_ops(rec, "process") if ops]
    return sum(counts) / len(counts) if counts else None
