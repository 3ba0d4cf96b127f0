"""Share (%) of the sense dispatch's roofline: the least time the call's work
needs on an H100 over the device time of every operation launched inside the
harness's ``sense_call`` spans, whatever its name.

The least time is the larger of the bytes over 3.35 TB/s and the FFT's
operations over 67 TFLOP/s (float32 outside the tensor cores).  Bytes: both
input planes read once; the averaged spectrum, the four features, three MLP
outputs and the decision written once per cycle; the twiddle and band tables
read once.  Operations: per input sample the nine radix-2 stages of a
512-point FFT (5 each) and the magnitude (``chip_smoke.py::sense_bound``'s
arithmetic, copied).
"""

from crn_bench.harness import FP32_FLOPS, HBM_BYTES_PER_S, span_ops


def least_seconds(cycles: int, averaging: int, n: int, itemsize: int) -> float:
    samples = cycles * averaging * n
    nbytes = samples * 2 * itemsize + cycles * (n + 4 + 3 + 1) * 4 + n * 8 + n * 16
    return max(nbytes / HBM_BYTES_PER_S, samples * 50 / FP32_FLOPS)


def read(rec):
    calls = [ops for ops in span_ops(rec, "sense_call") if ops]
    device_s = sum(float(e["dur"]) for ops in calls for e in ops) * 1e-6
    if not calls or device_s <= 0:
        return None
    c = rec["counters"]
    least = least_seconds(c["cycles"], c["averaging"], c["fft_length"], c["itemsize"])
    return 100.0 * least * len(calls) / device_s
