"""Share (%) of the wideband call's roofline: the least time the call's work
needs on an H100 over the device time of every operation launched inside the
harness's ``wideband_call`` spans, whatever its name.

The least time is the larger of the bytes over 3.35 TB/s and the operations
over 67 TFLOP/s (float32 outside the tensor cores).  Bytes: the interleaved
planes read once (8 bytes a wide sample), the carried history (8 rows of
both planes a stream, read and written), the taps and the twiddles read once,
and the energies, noise floors and decisions written once.  Operations per
wide sample: the FIR (2 planes x 8 taps x 2), the 64-point DFT (5 log2 64)
and the power (3).
"""

import math

from crn_bench.harness import FP32_FLOPS, HBM_BYTES_PER_S, span_ops


def call_bytes(streams: int, rows: int, block_len: int, m: int, p: int) -> int:
    cycles = rows // block_len
    planes = streams * rows * m * 8
    history = 2 * streams * 2 * 8 * m * 4
    tables = p * m * 4 + m * 4
    outputs = streams * cycles * (m * 4 + 4 + m)
    return planes + history + tables + outputs


def call_flops(streams: int, rows: int, m: int, p: int) -> float:
    return streams * rows * m * (2 * p * 2 + 5 * math.log2(m) + 3)


def least_seconds(streams: int, rows: int, block_len: int, m: int, p: int) -> float:
    return max(call_bytes(streams, rows, block_len, m, p) / HBM_BYTES_PER_S,
               call_flops(streams, rows, m, p) / FP32_FLOPS)


def read(rec):
    calls = [ops for ops in span_ops(rec, "wideband_call") if ops]
    device_s = sum(float(e["dur"]) for ops in calls for e in ops) * 1e-6
    if not calls or device_s <= 0:
        return None
    c = rec["counters"]
    least = least_seconds(c["streams"], c["rows"], c["block_len"], c["channels"], c["taps"])
    return 100.0 * least * len(calls) / device_s
