"""Time of the extract kernel on the card at the OFDM receive path's shapes.

    python -m cognitive_radio_network_tpu_torch.profile_extract [--json PATH]

Each gather is timed three ways, on planes and offsets made on the card:

* the kernel's device time per launch, from a ``torch.profiler`` trace
  (``key_averages`` over the kernels whose name holds ``extract_window``):
  what the kernel itself costs, whatever the host does;
* the time per call by CUDA events around back-to-back calls, which shows
  the wrapper's host time where that is the larger;
* the bound: each output byte written once and each distinct input sample
  that the windows cover read once, over the card's 3.35 TB/s.

Gathers: the link's frame windows (K=256 of 4864 samples at the frame starts
of ``chip_smoke.py`` phase 8's block, N=1,265,664); a stream step's windows
(phase 17's buffer, N=2,056,192, K=520 candidates at the frame starts of its
alternating 4864- and 2080-sample frames) as one launch per set (688, 4864,
2080) and the refinement windows (160); and the three sets in one launch of
``extract_window_sets``.  A checkout without ``extract_window_sets`` (the
design that launched once per set) gets the other rows, so two trees compare
in one run on one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.ops import extract as extract_mod

__all__ = ["device_us_per_launch", "events_ms_per_call", "gather_bytes"]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate
LINK_K, LINK_FLEN, LINK_GAP = 256, 4864, 80  # chip_smoke.py phase 8's link block
STEP_N, STEP_K, STEP_R_CAP = 2_056_192, 520, 16_384  # phase 17: residual + one block
STEP_FRAMES, STEP_GAP = (4864, 2080), 512  # its two configs' frame lengths, the gap
STEP_WLENS = (688, 4864, 2080)  # the header windows, then each config's frames
REFINE_WLEN = 160  # the timing refinement's windows at the default config


def gather_bytes(offs: torch.Tensor, n: int, wlens) -> int:
    """Bytes a gather must move: each output byte written once, each distinct
    sample of both planes that some window covers read once, and the offsets
    read once.  Offsets are clipped per set as the kernel clips them."""
    o = offs.cpu().numpy().astype(np.int64)
    marks = np.zeros(n + 1, np.int64)
    for w in wlens:
        if w and len(o):
            start = np.clip(o, 0, max(n - w, 0))
            np.add.at(marks, start, 1)
            np.add.at(marks, np.minimum(start + w, n), -1)
    covered = int((np.cumsum(marks[:n]) > 0).sum())
    return 2 * 4 * len(o) * sum(wlens) + 2 * 4 * covered + offs.numel() * offs.element_size()


def device_us_per_launch(fn, name: str = "extract_window", calls: int = 20) -> tuple[float, int]:
    """(us per launch, launches) on the card of the kernels whose name holds
    ``name``, over ``calls`` calls of ``fn``, from the profiler's kernel
    records.  Raises if the trace holds no such kernel."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for evt in prof.key_averages():
        if name in evt.key:
            dev_us = getattr(evt, "device_time_total", None)
            total += evt.cuda_time_total if dev_us is None else dev_us
            count += evt.count
    if count == 0 or total <= 0:
        raise RuntimeError(f"the profiler recorded no {name} kernel on the card")
    return total / count, count


def events_ms_per_call(fn, trials: int = 3, reps: int = 20) -> list[float]:
    """ms per call by CUDA events around ``reps`` back-to-back calls, per trial."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop) / reps)
    return out


def step_offsets(dev) -> torch.Tensor:
    """K=520 candidates of a stream step: the frame starts of the block's
    alternating frames after the residual, then noise candidates spread over
    the buffer, in no order (as the scan's top K)."""
    starts, pos, i = [], STEP_R_CAP, 0
    while len(starts) < STEP_K - 8:
        starts.append(pos)
        pos += STEP_FRAMES[i % 2] + STEP_GAP
        i += 1
    noise = np.random.default_rng(0).integers(0, STEP_N, STEP_K - len(starts))
    offs = np.random.default_rng(1).permutation(np.concatenate([starts, noise]))
    return torch.from_numpy(offs.astype(np.int64)).to(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="also write the rows as JSON to this path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_extract: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    g = torch.Generator(device=dev).manual_seed(5)
    n_link = LINK_K * (LINK_FLEN + LINK_GAP)
    link = [torch.randn(n_link, generator=g, device=dev) for _ in range(2)]
    link_offs = torch.arange(LINK_K, device=dev) * (LINK_FLEN + LINK_GAP)
    step = [torch.randn(STEP_N, generator=g, device=dev) for _ in range(2)]
    offs = step_offsets(dev)
    refine_offs = (offs - 48).clamp(0, STEP_N - REFINE_WLEN)
    one = extract_mod.extract_windows
    cases = [
        ("link frame windows", lambda: one(*link, link_offs, LINK_FLEN), link_offs, n_link,
         (LINK_FLEN,), 1),
        *((f"stream step wlen={w}, one launch", lambda w=w: one(*step, offs, w), offs, STEP_N,
           (w,), 1) for w in STEP_WLENS),
        ("stream step refinement wlen=160", lambda: one(*step, refine_offs, REFINE_WLEN),
         refine_offs, STEP_N, (REFINE_WLEN,), 1),
        ("stream step wlens 688+4864+2080, one launch per set",
         lambda: [one(*step, offs, w) for w in STEP_WLENS], offs, STEP_N, STEP_WLENS, 3),
    ]
    sets = getattr(extract_mod, "extract_window_sets", None)
    if sets is not None:
        cases.append(("stream step wlens 688+4864+2080, one launch", lambda: sets(*step, offs,
                      STEP_WLENS), offs, STEP_N, STEP_WLENS, 1))
    rows = []
    for label, fn, o, n, wlens, launches in cases:
        dev_us, count = device_us_per_launch(fn)
        ev = events_ms_per_call(fn)
        nbytes = gather_bytes(o, n, wlens)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        card_ms = dev_us * launches / 1e3  # the call's kernel time on the card
        rows.append({"gather": label, "k": int(o.numel()), "n": n, "wlens": list(wlens),
                     "launches_per_call": launches, "device_us_per_launch": dev_us,
                     "device_ms_per_call": card_ms, "events_ms_per_call": ev,
                     "bytes": nbytes, "bound_ms": bound_ms})
        gbs = nbytes / (card_ms * 1e-3) / 1e9
        print(f"[profile-extract] {label}: K={o.numel()} N={n}: on the card {dev_us:.2f} us per "
              f"launch ({count} launches profiled), {card_ms:.4f} ms per call, {gbs:.0f} GB/s "
              f"({gbs / 3350:.1%} of 3.35 TB/s), {card_ms / bound_ms:.2f}x the bound "
              f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} "
              f"MB); CUDA events {', '.join(f'{t:.4f}' for t in ev)} ms per call; {smi}",
              flush=True)
    if args.json:
        path = Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"device": smi, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
