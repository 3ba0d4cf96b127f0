"""Share (%) of the extract kernel's roofline inside the device stream steps:
the least time of the work of the extract launches inside the program's
``rx.step`` spans over their device time, both per launch, in the traced
window.

The work of a gather (:func:`gather_bytes`, ``PERF.md``'s row 2): each
output byte written once (both float32 planes of every window), each distinct
input sample of both planes that some window covers read once (offsets
clipped per window set as the kernel clips them), and the offsets read once,
at 3.35 TB/s.  The driver notes each gather a step launches (its offsets,
the planes' length and its window lengths) in the counter
``extract_gathers``; none where it noted none or no extract launch lies
inside an ``rx.step`` span, as on a program without that span.
"""

import numpy as np

from crn_bench.harness import HBM_BYTES_PER_S, span_ops

KERNEL = "extract_window"  # the kernel's name holds this (csrc/extract_windows.cu)


def gather_bytes(offsets, n: int, wlens) -> int:
    """Bytes one gather must move: windows of ``wlens`` at ``offsets`` into
    planes of ``n`` samples."""
    o = np.asarray(offsets, np.int64)
    starts, ends = [], []
    for w in wlens:
        if w and len(o):
            s = np.clip(o, 0, max(n - w, 0))
            starts.append(s)
            ends.append(np.minimum(s + w, n))
    covered = 0
    if starts:
        s, e = np.concatenate(starts), np.concatenate(ends)
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
        reach = np.maximum.accumulate(e)
        # a new run of covered samples starts where a window begins past all earlier ends
        new = np.concatenate(([True], s[1:] > reach[:-1]))
        run_end = np.maximum.reduceat(e, np.flatnonzero(new))
        covered = int((run_end - s[new]).sum())
    return 2 * 4 * len(o) * int(sum(wlens)) + 2 * 4 * covered + 8 * len(o)


def read(rec):
    gathers = rec["counters"].get("extract_gathers") or []
    launches = [e for ops in span_ops(rec, "rx.step") for e in ops if KERNEL in e["name"]]
    device_s = sum(float(e["dur"]) for e in launches) * 1e-6
    if not gathers or not launches or device_s <= 0:
        return None
    least = sum(gather_bytes(*g) for g in gathers) / HBM_BYTES_PER_S
    return 100.0 * (least / len(gathers)) / (device_s / len(launches))
