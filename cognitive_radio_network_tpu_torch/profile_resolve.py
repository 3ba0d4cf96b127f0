"""Times of three ways to walk one block's frame candidates on a CUDA card.

    python -m cognitive_radio_network_tpu_torch.profile_resolve [-k 520]

The adaptive stream step resolves K candidates in offset order
(``ops/resolve.py``).  On a table shaped like a full-width step's (K frames of
two lengths in turn, 512 samples apart, the last one cut by the buffer's end)
this times, by CUDA events:

* the kernel, ``resolve_candidates``: what the step runs;
* the plain version, ``resolve_candidates_plain``: columns to the host, a
  Python loop, the result back: it waits for the card, so steps could not queue;
* the walk as PyTorch operations on 0-d device tensors: no copy, but a few
  dozen launches per candidate.

All three must agree (``torch.equal``).  The last two are the designs the
kernel was chosen over; ``chip_smoke.py`` holds the kernel to the plain version
on a real step's columns.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys

import torch

from cognitive_radio_network_tpu_torch.ops.resolve import (
    resolve_candidates,
    resolve_candidates_plain,
)

FRAME_LENS, GAP, PREFIX, THRESHOLD = (4864, 2080), 512, 304, 0.2


def resolve_by_tensor_ops(offs, peaks, ok, flen, keep0, thr, n, prefix):
    """The candidate walk as PyTorch operations on 0-d device tensors."""
    dev = offs.device
    consumed = torch.zeros((), dtype=torch.int64, device=dev)
    stopped = torch.zeros((), dtype=torch.bool, device=dev)
    keep_from = keep0.reshape(())
    accept = torch.zeros(offs.shape[0], dtype=torch.bool, device=dev)
    for i in range(offs.shape[0]):
        off, fl = offs[i], flen[i]
        considered = ~stopped & (peaks[i] >= thr) & (off >= consumed)
        prefix_overrun = considered & (off + prefix > n)
        after_hdr = considered & ~prefix_overrun & ok[i]
        frame_overrun = after_hdr & (off + fl > n)
        take = after_hdr & ~frame_overrun
        consumed = torch.where(take, off + fl, consumed)
        stop_now = prefix_overrun | frame_overrun
        keep_from = torch.where(stop_now, torch.minimum(keep_from, off), keep_from)
        stopped = stopped | stop_now
        accept[i] = take
    return accept, torch.stack([consumed, keep_from, stopped.to(torch.int64)])


def _time_ms(fn, args, reps: int) -> float:
    """Median over 3 runs of the mean time of ``reps`` calls, by CUDA events."""
    fn(*args)
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        stop.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(stop) / reps)
    return statistics.median(runs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-k", type=int, default=520, help="candidates per block")
    k = ap.parse_args(argv).k
    if not torch.cuda.is_available():
        print("profile_resolve: this run needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    flen = torch.tensor(FRAME_LENS, device=dev).repeat(-(-k // 2))[:k]
    offs = torch.cumsum(flen + GAP, 0) - flen - GAP
    n = int(offs[-1]) + 1000  # the last frame's tail has not arrived
    gen = torch.Generator(device=dev).manual_seed(0)
    peaks = 0.5 + 0.5 * torch.rand(k, generator=gen, device=dev)
    ok = torch.ones(k, dtype=torch.bool, device=dev)
    keep0 = torch.full((1,), n - PREFIX, dtype=torch.int64, device=dev)
    args = (offs, peaks, ok, flen, keep0, THRESHOLD, n, PREFIX)
    want = resolve_candidates_plain(*args)
    for what, fn in (("kernel", resolve_candidates), ("tensor operations", resolve_by_tensor_ops)):
        got = fn(*args)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"the walk by {what} differs from the plain version")
    print(f"K={k} candidates, {int(want[0].sum())} accepted, all three walks torch.equal; {smi}")
    for what, fn, reps in (("kernel", resolve_candidates, 200),
                           ("plain version through the host", resolve_candidates_plain, 5),
                           ("PyTorch operations on 0-d tensors", resolve_by_tensor_ops, 1)):
        print(f"{what}: {_time_ms(fn, args, reps):.4f} ms/call, median of 3 runs of {reps}; {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
