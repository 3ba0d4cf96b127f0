"""Profile of one OFDM link receive call on a CUDA card, stage by stage.

    python -m cognitive_radio_network_tpu_torch.profile_link [--trace PATH]

Builds the link block of ``chip_smoke.py`` phase 8 on the card (256
default-config frames with 256-byte payloads and 80-sample gaps,
N=1,265,664) and times ``rx_block_fn(k=256)`` three ways: plain (host
clock, 5 runs of 5 calls), with a ``record_function`` range around each
stage (same), and under ``torch.profiler`` (5 calls), whose chrome trace is
written to ``--trace``.

Stages (each range includes what it calls):

    A _sc_metric        B _topk_core        C _refine
    D extract_windows   E _demod_graph      F _decode_header_graph
    G fec.decode_bits   H crc.crc_check

Device time per stage is read from the trace, not from the profiler's
table: a stage owns the device operations (kernels, copies, fills) whose
launch call on the host (``cuda_runtime``/``cuda_driver`` events) lies
inside one of the stage's host ranges, matched by correlation id.  The
table's device column for a ``record_function`` is instead the span of its
GPU-side range, idle gaps included, which overstates a stage that launches
small kernels one by one.
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

__all__ = ["STAGES", "stage_device_times"]

FRAMES, GAP, PAYLOAD = 256, 80, 256  # the link block of chip_smoke.py phase 8
CALL = "rx_block_fn call"

# (label, module attribute patched with a record_function wrapper)
STAGES = (
    ("A detect: S&C metric", "framesync._sc_metric"),
    ("B detect: top-K + refine", "framesync._topk_core"),
    ("C refine", "framesync._refine"),
    ("D extract kernel", "framesync.extract_windows"),
    ("E demod (equalize, DFT, slice)", "framesync._demod_graph"),
    ("F header FEC+CRC", "framesync._decode_header_graph"),
    ("G FEC decode", "fec.decode_bits"),
    ("H CRC check", "crc.crc_check"),
)
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def stage_device_times(trace: dict, labels) -> dict:
    """Chrome trace of a ``torch.profiler`` run -> {label: (ranges, host us,
    device us, device ops)} summed over every host range named ``label``.

    A device operation counts for a range when the host call that launched
    it (same correlation id) starts inside the range on the same thread."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    device = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in _DEVICE_CATS and corr is not None:
            device.setdefault(corr, []).append(float(e["dur"]))
    launches = defaultdict(list)  # (pid, tid) -> [(ts, correlation)]
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in _LAUNCH_CATS and corr in device:
            launches[(e["pid"], e["tid"])].append((float(e["ts"]), corr))
    out = {}
    for label in labels:
        n, host, dev, ops = 0, 0.0, 0.0, 0
        for e in events:
            if e.get("cat") != "user_annotation" or e.get("name") != label:
                continue
            t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            n, host = n + 1, host + float(e["dur"])
            for ts, corr in launches[(e["pid"], e["tid"])]:
                if t0 <= ts <= t1:
                    dev += sum(device[corr])
                    ops += len(device[corr])
        out[label] = (n, host, dev, ops)
    return out


def _annotated(label: str, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    return wrapper


def _wall_ms(fn, runs: int = 5, calls: int = 5) -> list[float]:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / calls * 1e3)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", default="chiprun_out/link_trace.json",
                    help="where the profiler's chrome trace is written")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_link: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    from cognitive_radio_network_tpu_torch.phy import OFDMFrameConfig, OFDMFrameGen, OFDMFrameSync
    from cognitive_radio_network_tpu_torch.phy import crc, fec, framesync

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    cfg = OFDMFrameConfig()
    gen = OFDMFrameGen(cfg, PAYLOAD)
    rng = np.random.default_rng(0)
    hdrs = rng.integers(0, 256, (FRAMES, 8)).astype(np.uint8)
    pays = rng.integers(0, 256, (FRAMES, PAYLOAD)).astype(np.uint8)
    frames = gen.assemble(hdrs, pays, as_planes=True)  # on the card, the default device
    block = torch.cat([frames, torch.zeros((FRAMES, GAP, 2), device=dev)], dim=1).reshape(-1, 2)
    rr, ri = block[:, 0].contiguous(), block[:, 1].contiguous()
    n = rr.shape[0]
    nvalid = torch.tensor(n, device=dev)
    rxfn = OFDMFrameSync(cfg, PAYLOAD).rx_block_fn(k=FRAMES)
    _, _, _, out, ok = rxfn(rr, ri, nvalid)
    if int(ok.sum()) != FRAMES or not bool(out["pay_ok"].all()):
        raise AssertionError(f"{int(ok.sum())}/{FRAMES} frames decoded")

    def report(label: str, runs: list[float]) -> float:
        med = statistics.median(runs)
        print(f"wall per call, {label} (host clock, 5 runs of 5): "
              f"{', '.join(f'{t:.4f}' for t in runs)} ms; median {med:.4f} ms; {smi}", flush=True)
        return med

    plain_ms = report("plain code", _wall_ms(lambda: rxfn(rr, ri, nvalid)))

    modules = {"framesync": framesync, "fec": fec, "crc": crc}
    saved = []
    for label, target in STAGES:
        mod, attr = target.split(".")
        fn = getattr(modules[mod], attr)
        saved.append((modules[mod], attr, fn))
        setattr(modules[mod], attr, _annotated(label, fn))
    try:
        report("stages annotated", _wall_ms(lambda: rxfn(rr, ri, nvalid)))
        calls = 5
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                with torch.profiler.record_function(CALL):
                    rxfn(rr, ri, nvalid)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) / calls * 1e3
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)

    path = Path(args.trace)
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    times = stage_device_times(trace, [CALL] + [label for label, _ in STAGES])
    _, _, call_dev, call_ops = times[CALL]
    if call_ops == 0:
        raise AssertionError("the trace holds no device operation launched by the call")
    print(f"profiled: wall {prof_ms:.4f} ms/call; device ops {call_ops / calls:.1f}/call, "
          f"busy {call_dev / calls:.1f} us/call; idle share of an unprofiled call "
          f"{1 - call_dev / calls / (plain_ms * 1e3):.1%}; trace {path}", flush=True)
    print("stage | ranges/call | host ms/call (incl. children) | device us/call (incl. children)"
          " | device ops/call")
    for label, _ in STAGES:
        n_r, host, dev_us, ops = times[label]
        print(f"{label} | {n_r / calls:g} | {host / calls / 1e3:.4f} | {dev_us / calls:.1f} | "
              f"{ops / calls:g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
