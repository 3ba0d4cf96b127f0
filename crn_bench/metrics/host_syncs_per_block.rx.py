"""Synchronizing runtime calls per ``StreamReceiver.process`` call: stream,
device and event synchronizes and synchronous (non-async) copies that the
call's thread made inside it, from the trace."""

from crn_bench.harness import span_calls

SYNCHRONOUS_COPIES = ("cudaMemcpy", "cuMemcpyDtoH_v2", "cuMemcpyHtoD_v2", "cuMemcpy")


def synchronizing(name: str) -> bool:
    return "Synchronize" in name or name in SYNCHRONOUS_COPIES


def read(rec):
    counts = span_calls(rec, "process", synchronizing)
    return sum(counts) / len(counts) if counts else None
