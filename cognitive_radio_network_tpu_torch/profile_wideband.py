"""Time of the wideband kernel on the card, against its bound.

    python -m cognitive_radio_network_tpu_torch.profile_wideband [--json PATH]

Shapes: one planar stream at T = 131,072, 262,144 and 524,288 rows of 64
channels (``WidebandConfig()``, ``block_len`` 128), the wideband train
step's batch of 4 streams of T = 65,536 as planar streams and as interleaved
(B, T*64, 2) planes, and the ``wideband64`` deployment's calls: 48
interleaved streams of T = 20,480 and 40,960 (160 and 320 cycles) with a
history per stream, energies only and, where the tree has
``wideband_detect_fused``, as a continuous ``make_wideband_fn`` call runs
them: with the decisions and each stream's tail written in the launch.
Each is timed three ways, on inputs made on the card:

* the kernel's time on the card per call, from a ``torch.profiler`` trace
  (the kernels whose name holds ``fused_wideband``), and every device
  operation of the call (a de-interleaving copy included);
* the time per call by CUDA events around back-to-back calls;
* the bound: both planes read once and the energies written once over the
  card's 3.35 TB/s, or the FIR, FFT and power over 67 TFLOP/s, the larger.

Where an input fits the 50 MB L2 cache, a 64 MB write flushes it between
profiled calls (no shape here fits).  Beside each shape, ``torch.sum`` over
the same planes gives the read rate this card reaches; after the single
streams, a least-squares fit of time = fixed + T x (512 bytes / rate) gives
the fixed microseconds a launch and the marginal rate.

A checkout whose wrapper takes one stream a call (no
``wideband_energy_fused_planes``: the first design) runs the batch stream by
stream and the interleaved batch through ``split_iq`` first, as its
``wideband_sense`` does, so the script copied into such a tree times it the
same way, and two trees compare in one run on one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.ops import fused_wideband as fw
from cognitive_radio_network_tpu_torch.parallel.wideband import WidebandConfig
from cognitive_radio_network_tpu_torch.signal.iq import split_iq

__all__ = ["measure", "profile_call", "wide_bound"]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate
FP32_FLOPS = 67e12  # H100 SXM float32 rate outside the tensor cores
L2_BYTES = 50e6
SINGLE_T = (131_072, 262_144, 524_288)
BATCH, BATCH_T = 4, 65_536  # the wideband train step's batch (chip_smoke.py phase 25)
FLEET, FLEET_T = 48, (20_480, 40_960)  # the wideband64 deployment's calls (crn_bench/configs/wideband64.json)


def wide_bound(streams: int, t: int, block_len: int = 128, m: int = 64,
               history: bool = False, detect: bool = False) -> tuple[float, str, int]:
    """(ms, "bytes" or "operations", bytes) of the least time for ``streams``
    streams of T=``t``: planes read once (and with ``history`` each stream's
    8 rows before it), taps read and energies written once (with ``detect``
    also the noise floors, the decisions and each stream's last 8 rows); per
    row the FIR (2 planes x 64 channels x 8 taps x 2), a 64-point complex FFT
    (5 N log2 N) and the power (3 x 64)."""
    nbytes = streams * (2 * t * m * 4 + t // block_len * m * 4) + 8 * m * 4
    nbytes += streams * 2 * 8 * m * 4 if history else 0
    nbytes += streams * (t // block_len * (4 + m) + 2 * 8 * m * 4) if detect else 0
    flops = streams * t * (2 * m * 8 * 2 + 5 * m * 6 + 3 * m)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (by_bytes, "bytes", nbytes) if by_bytes >= by_ops else (by_ops, "operations", nbytes)


def profile_call(fn, name: str = "fused_wideband", calls: int = 20, flush=None) -> dict:
    """Per call of ``fn`` on the card, from the profiler's kernel records:
    ms of the kernels whose name holds ``name``, their launches, ms and count
    of every device kernel (``flush``'s excluded)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            if flush is not None:
                with torch.profiler.record_function("l2_flush"):
                    flush()
            fn()
        torch.cuda.synchronize()
    kern_us = all_us = 0.0
    kern_n = all_n = 0
    flush_us = 0.0
    for evt in prof.key_averages():
        dev_us = getattr(evt, "device_time_total", None)
        dev_us = evt.cuda_time_total if dev_us is None else dev_us
        if dev_us <= 0 or evt.key in ("l2_flush",) or evt.key.startswith("aten::"):
            continue  # host spans, and operators whose kernels are listed themselves
        if flush is not None and "fill" in evt.key.lower():
            flush_us += dev_us
            continue
        all_us += dev_us
        all_n += evt.count
        if name in evt.key:
            kern_us += dev_us
            kern_n += evt.count
    if kern_n == 0:
        raise RuntimeError(f"the profiler recorded no {name} kernel on the card")
    return {"kernel_ms": kern_us / calls / 1e3, "launches": kern_n / calls,
            "device_ms": all_us / calls / 1e3, "device_ops": all_n / calls}


def events_ms(fn, trials: int = 3, reps: int = 20) -> list[float]:
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


def calls(taps, cfg) -> dict:
    """The tree's way to energies from planar streams and from interleaved
    planes, batched or not."""
    if hasattr(fw, "wideband_energy_fused_planes"):
        return {
            "planar": lambda xr, xi: fw.wideband_energy_fused(xr, xi, taps, cfg),
            "planes": lambda p, h=None: fw.wideband_energy_fused_planes(p, taps, cfg,
                                                                       initial_history=h),
            "tree": "one launch a call",
        }

    def planar(xr, xi):
        if xr.dim() == 1:
            return fw.wideband_energy_fused(xr, xi, taps, cfg)
        return torch.stack([fw.wideband_energy_fused(r, i, taps, cfg) for r, i in zip(xr, xi)])

    return {"planar": planar, "planes": lambda p: planar(*split_iq(p)),
            "tree": "one launch a stream"}


def measure(dev, smi: str, tag: str = "[profile-wideband]") -> dict:
    """Every shape of the module docstring on card ``dev``, each printed as one
    line beside ``smi`` (the card's name and power limit); returns the rows
    and the fit."""
    cfg = WidebandConfig()
    taps = torch.from_numpy(cfg.taps()).to(dev)
    use = calls(taps, cfg)
    print(f"{tag} tree: {use['tree']}; {smi}", flush=True)
    g = torch.Generator(device=dev).manual_seed(9)
    big = [torch.randn(SINGLE_T[-1] * 64, generator=g, device=dev) for _ in range(2)]
    planes = torch.randn(BATCH, BATCH_T * 64, 2, generator=g, device=dev)
    batch_planar = [planes[..., 0].contiguous(), planes[..., 1].contiguous()]
    cases = [(f"stream T={t}", 1, t, lambda t=t: use["planar"](big[0][: t * 64], big[1][: t * 64]),
              lambda t=t: (big[0][: t * 64].sum(), big[1][: t * 64].sum())) for t in SINGLE_T]
    cases += [
        (f"batch ({BATCH}, {BATCH_T}) planar", BATCH, BATCH_T,
         lambda: use["planar"](*batch_planar), lambda: [v.sum() for v in batch_planar]),
        (f"batch ({BATCH}, {BATCH_T}) interleaved", BATCH, BATCH_T,
         lambda: use["planes"](planes), lambda: planes.sum()),
    ]
    if use["tree"] == "one launch a call":  # a tree that takes a history per stream
        fleet = torch.randn(FLEET, max(FLEET_T) * 64, 2, generator=g, device=dev)
        hist = tuple(torch.randn(FLEET, 4, 128, generator=g, device=dev) for _ in range(2))
        tail = tuple(torch.empty(FLEET, 4, 128, device=dev) for _ in range(2))
        for t in FLEET_T:
            part = fleet[:, : t * 64]
            cases.append((f"deployment ({FLEET}, {t}) interleaved, with history", FLEET, t,
                          lambda p=part: use["planes"](p, hist), lambda p=part: p.sum()))
            if hasattr(fw, "wideband_detect_fused"):
                cases.append((f"deployment ({FLEET}, {t}) detect, with history and tail", FLEET, t,
                              lambda p=part: fw.wideband_detect_fused(p, taps, cfg, initial_history=hist,
                                                                      tail_out=tail),
                              lambda p=part: p.sum()))
    scratch = torch.empty(int(64e6) // 4, device=dev)
    rows = []
    for label, streams, t, fn, yardstick in cases:
        bound_ms, bound_by, nbytes = wide_bound(streams, t, history="history" in label,
                                                detect="detect" in label)
        flush = (lambda: scratch.fill_(0.0)) if nbytes < L2_BYTES else None
        prof = profile_call(fn, flush=flush)
        ev = events_ms(fn)
        sum_ms = profile_call(yardstick, name="reduce", flush=flush)["device_ms"]
        card = prof["kernel_ms"]
        gbs = nbytes / (card * 1e-3) / 1e9
        rows.append({"case": label, "streams": streams, "t": t, "bytes": nbytes,
                     "bound_ms": bound_ms, "bound_by": bound_by, **prof,
                     "events_ms": ev, "sum_ms": sum_ms})
        print(f"{tag} {label}: kernel on the card {card:.4f} ms per call ({prof['launches']:.0f} "
              f"launches), {gbs:.0f} GB/s ({gbs / 3350:.1%} of 3.35 TB/s), {card / bound_ms:.2f}x "
              f"its bound {bound_ms:.4f} ms by {bound_by} ({bound_ms / card:.1%} of it); the "
              f"call's {prof['device_ops']:.0f} device operations {prof['device_ms']:.4f} ms; "
              f"CUDA events {', '.join(f'{x:.4f}' for x in ev)} ms per call; torch.sum over the "
              f"same planes {sum_ms:.4f} ms; {smi}", flush=True)
    single = rows[: len(SINGLE_T)]
    slope, fixed = np.polyfit([r["t"] for r in single], [r["kernel_ms"] for r in single], 1)
    rate = 512 / (slope * 1e-3) / 1e12  # bytes a row over the marginal time of a row
    print(f"{tag} fit over the single streams: time = {fixed * 1e3:.2f} us + T x "
          f"{slope * 1e6:.4f} ns, so {fixed * 1e3:.2f} us fixed a launch and a marginal "
          f"{rate:.2f} TB/s; {smi}", flush=True)
    return {"device": smi, "tree": use["tree"], "rows": rows, "fixed_us": fixed * 1e3,
            "marginal_tbs": rate}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="also write the rows as JSON to this path")
    ap.add_argument("--label", default="", help="a name for this tree in the output")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_wideband: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    tag = f"[profile-wideband{' ' + args.label if args.label else ''}]"
    out = measure(torch.device("cuda", 0), smi, tag)
    if args.json:
        path = Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
