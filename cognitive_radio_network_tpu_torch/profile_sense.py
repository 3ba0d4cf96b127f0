"""Where a sense dispatch's time goes on the card, and the sense kernels' times.

    python -m cognitive_radio_network_tpu_torch.profile_sense [--json PATH]

On planes made on the card and the reference weights on the card:

* ``make_sense_fn(SenseConfig())`` at C = 4096 (the reference bench's
  dispatch), 256 (the CLI's) and 1 (the predictive engine's) cycles, and the
  same with ``with_trace=True``: the host clock per synchronized call (median
  of 5 runs of 5 calls), then a ``torch.profiler`` trace of 10 calls: device
  operations, busy us, the sense kernels' us (the kernels whose name holds
  ``fused_sense`` or ``sense_trace``) and the device's idle share;
* one classify of ``CEPredictiveNode`` (its ten buffers stacked on the host,
  one upload, the sense function, one ``.item()``), measured the same way;
* at C = 4096, f32 and bf16 planes, ``fused_sense_ct`` and, where the tree has
  it, ``fused_sense_classify`` with the reference weights, by CUDA events in
  turns (ct, classify, classify, ct; median of 3 runs of 10 calls over input
  sets larger than the 50 MB L2 cache), and on the card: the median of the
  profiler's kernel durations over 10 alternations of 10 launches of each;
  and the trace kernel alone;
* the host time of a call at C=1 (the least of 10 runs of 300 calls by the
  host clock, the card drained between runs): ``fused_sense_ct``,
  ``fused_sense_classify`` and a ``make_sense_fn`` call.

It runs on a tree without ``fused_sense_classify`` too (copy the file in):
there the sense function is the kernel and the eager chain after it, so two
trees compare in one run on one card.  Every line names the card and its
power limit.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.models import SenseConfig, make_sense_fn
from cognitive_radio_network_tpu_torch.signal.mlp import reference_weights

# the module (the package's ``ops`` re-exports the function under its name)
fsc = importlib.import_module("cognitive_radio_network_tpu_torch.ops.fused_sense_ct")

__all__ = ["measure", "measure_calls", "measure_kernels", "profiled"]

CYCLES = (4096, 256, 1)
ROUNDS = 10  # alternations of the sense kernels under the profiler
KERNEL_NAMES = ("fused_sense", "sense_trace")  # the sense kernels' names hold one of these


def _span_times(trace: dict, label: str) -> list[tuple[float, int, float]]:
    """For each ``record_function(label)`` span of a Chrome trace: device busy
    us, device operations (launched inside the span on its thread) and the us
    of the sense kernels among them."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    device = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and corr is not None:
            device.setdefault(corr, []).append(e)
    launches = [(float(e["ts"]), e["pid"], e["tid"], e["args"]["correlation"]) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("args", {}).get("correlation") in device]
    spans = []
    for span in events:
        if span.get("cat") != "user_annotation" or span.get("name") != label:
            continue
        t0, t1 = float(span["ts"]), float(span["ts"]) + float(span["dur"])
        ops = [d for ts, pid, tid, corr in launches
               if t0 <= ts <= t1 and (pid, tid) == (span["pid"], span["tid"]) for d in device[corr]]
        spans.append((sum(float(d["dur"]) for d in ops), len(ops),
                      sum(float(d["dur"]) for d in ops if any(k in d["name"] for k in KERNEL_NAMES))))
    return spans


def _chrome_trace(prof, label: str) -> dict:
    """The profiler's Chrome trace, through a file under build/ that is removed."""
    path = Path(__file__).resolve().parents[1] / "build" / f"profile_sense_{label}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        prof.export_chrome_trace(str(path))
        return json.loads(path.read_text())
    finally:
        path.unlink(missing_ok=True)


def profiled(fn, label: str, calls: int = 10) -> dict:
    """Host clock per synchronized call of ``fn`` (median of 5 runs of 5),
    then a profiler trace of ``calls`` synchronized calls: per call, device
    operations (the most in any call), busy us and the sense kernels' us, and
    the idle share.  The profiler may drop a call's device records (in a
    process that has traced much before, it has kept as few as 3 of 5), so
    these come from the calls whose records it kept (``kept``); none kept
    raises."""
    fn()
    torch.cuda.synchronize()
    wall = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
            torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) / 5 * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            with torch.profiler.record_function(label):
                fn()
            torch.cuda.synchronize()
    kept = [sp for sp in _span_times(_chrome_trace(prof, label), label) if sp[1] > 0]
    if not kept:
        raise AssertionError(f"{label}: the trace holds no device operation")
    ms = statistics.median(wall)
    busy = statistics.mean(sp[0] for sp in kept)
    return {"ms": ms, "ops": max(sp[1] for sp in kept), "busy_us": busy,
            "kernel_us": statistics.mean(sp[2] for sp in kept), "idle": 1 - busy / (ms * 1e3),
            "kept": f"{len(kept)} of {calls}"}


def _events_ms(fn, inputs, trials: int = 3, reps: int = 10) -> float:
    """Median over ``trials`` of the mean ms per call of ``reps`` calls, by
    CUDA events, cycling through ``inputs``."""
    for args in inputs:
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(reps):
            fn(*inputs[i % len(inputs)])
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def host_us(fn, calls: int = 300, runs: int = 10) -> float:
    """Host us per call of ``fn``: the least of ``runs`` runs of ``calls``
    calls, the card drained between runs and not inside them."""
    for _ in range(50):
        fn()
    best = float("inf")
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return best


def engine_classify(dev):
    """One ``CEPredictiveNode`` classify as the scenario runtime calls it, on a
    radio stub that holds the device and the tx frequency."""
    from cognitive_radio_network_tpu_torch.engines.predictive_node import CEPredictiveNode

    radio = types.SimpleNamespace(device=dev, get_tx_freq=lambda: 833e6, set_tx_freq=lambda f: None)
    eng = CEPredictiveNode(radio)
    rng = np.random.default_rng(0)
    buffers = [(rng.standard_normal(512) + 1j * rng.standard_normal(512)).astype(np.complex64) * 1e-3
               for _ in range(eng.cfg.averaging)]

    def classify():
        eng.buffers = list(buffers)
        eng._classify_and_act()

    return classify


def measure_calls(out: dict, dev, params, gen, smi: str) -> None:
    """The sense function's calls and the engine's classify, into ``out``."""
    cfg = SenseConfig()
    a, n = cfg.averaging, cfg.fft_length
    fn, fn_trace = make_sense_fn(cfg), make_sense_fn(cfg, with_trace=True)
    for c in CYCLES:
        xr = torch.randn(c * a, n, generator=gen, device=dev)
        xi = torch.randn(c * a, n, generator=gen, device=dev)
        for label, call in ((f"sense_c{c}", lambda: fn((xr, xi), params)),
                            (f"sense_trace_c{c}", lambda: fn_trace((xr, xi), params, 833e6))):
            r = profiled(call, label)
            out["calls"][label] = r
            print(f"[sense-profile] {label}: {r['ms']:.4f} ms per synchronized call by host clock, "
                  f"{r['ops']} device operations, {r['busy_us']:.1f} us busy, of which the sense "
                  f"kernels {r['kernel_us']:.1f} us, device idle {r['idle']:.1%} (the profiler kept "
                  f"{r['kept']} calls); {smi}", flush=True)
    r = profiled(engine_classify(dev), "classify")
    out["calls"]["engine_classify"] = r
    print(f"[sense-profile] one CEPredictiveNode classify (C=1: one upload, the sense function, one "
          f".item()): {r['ms']:.4f} ms by host clock, {r['ops']} device operations, "
          f"{r['busy_us']:.1f} us busy ({r['kernel_us']:.1f} us the sense kernels), device idle "
          f"{r['idle']:.1%} (the profiler kept {r['kept']} calls); {smi}", flush=True)


def measure_kernels(out: dict, dev, params, gen, smi: str) -> None:
    """The kernels' times at C=4096 and the wrappers' host time at C=1, into ``out``."""
    cfg = SenseConfig()
    a, n = cfg.averaging, cfg.fft_length
    fn = make_sense_fn(cfg)
    c = CYCLES[0]
    bufs = -(-64 * 2**20 // (c * a * n * 8))  # > 50 MB of L2 in all
    w = (params.w1, params.b1, params.w2, params.b2)
    has_classify = hasattr(fsc, "fused_sense_classify")
    for dtype in (torch.float32, torch.bfloat16):
        inputs = [tuple(torch.randn(c * a, n, generator=gen, device=dev).to(dtype) for _ in range(2))
                  for _ in range(bufs)]

        def ct(xr, xi):
            return fsc.fused_sense_ct(xr, xi, averaging=a)

        def classify(xr, xi):
            return fsc.fused_sense_classify(xr, xi, *w, averaging=a)

        forms = [("fused_sense_ct", ct)] + ([("fused_sense_classify", classify)] if has_classify else [])
        # CUDA events, in turns (ct, classify, classify, ct)
        got = {}
        for name, f in forms + forms[::-1]:
            got.setdefault(name, []).append(_events_ms(f, inputs))
        # the kernels' own time on the card: the profiler's durations over
        # ROUNDS alternations of 10 calls of each form
        on_card = {name: [] for name, _ in forms}
        acts = [torch.profiler.ProfilerActivity.CUDA]
        for _ in range(ROUNDS):
            for name, f in forms:
                with torch.profiler.profile(activities=acts) as prof:
                    for i in range(10):
                        f(*inputs[i % len(inputs)])
                    torch.cuda.synchronize()
                on_card[name] += [float(e["dur"]) for e in _chrome_trace(prof, "kernels")
                                  ["traceEvents"] if e.get("ph") == "X"
                                  and e.get("cat") == "kernel" and "fused_sense" in e["name"]]
        med = {name: statistics.median(v) / 1e3 for name, v in on_card.items()}
        key = "f32" if dtype == torch.float32 else "bf16"
        out["kernels"][key] = {"events_ms": got, "on_card_ms": med,
                               "on_card_launches": {k: len(v) for k, v in on_card.items()}}
        line = ", ".join(f"{k} {', '.join(f'{v:.4f}' for v in vs)}" for k, vs in got.items())
        card = ", ".join(f"{k} {v:.4f}" for k, v in med.items())
        ratio = (f", classify / ct {med['fused_sense_classify'] / med['fused_sense_ct']:.4f}"
                 if has_classify else "")
        print(f"[sense-kernels] C={c} {key}: ms per call by CUDA events in turns: {line}; on the "
              f"card (profiler, median of {ROUNDS} x 10 launches each, alternating): {card}{ratio}; "
              f"{smi}", flush=True)
        if has_classify and dtype == torch.float32:
            plain = _events_ms(lambda xr, xi: fsc.fused_sense_classify_plain(xr, xi, *w), inputs)
            out["kernels"]["classify_plain_ms"] = plain
            print(f"[sense-kernels] C={c} f32: fused_sense_classify_plain {plain:.4f} ms per call "
                  f"by CUDA events; {smi}", flush=True)
        del inputs
    if hasattr(fsc, "sense_trace"):
        dec = torch.randint(0, 4, (c,), generator=gen, device=dev, dtype=torch.int32)
        ms = _events_ms(lambda d: fsc.sense_trace(d, 833e6), [(dec,)])
        plain = _events_ms(lambda d: fsc.sense_trace_plain(d, 833e6), [(dec,)])
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fsc.sense_trace(dec, 833e6)
            torch.cuda.synchronize()
        card = statistics.median(
            float(e["dur"]) for e in _chrome_trace(prof, "trace")["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "kernel" and "sense_trace" in e["name"]) / 1e3
        out["kernels"]["sense_trace"] = {"ms": ms, "plain_ms": plain, "on_card_ms": card}
        print(f"[sense-kernels] sense_trace C={c}: kernel {ms:.4f} ms by CUDA events (host-bound), "
              f"{card:.4f} ms on the card (profiler, median of 20); plain {plain:.4f} ms by CUDA "
              f"events; {smi}", flush=True)
    xr, xi = (torch.randn(a, n, generator=gen, device=dev) for _ in range(2))
    host = {"fused_sense_ct": host_us(lambda: fsc.fused_sense_ct(xr, xi, averaging=a)),
            "make_sense_fn": host_us(lambda: fn((xr, xi), params))}
    if has_classify:
        host["fused_sense_classify"] = host_us(lambda: fsc.fused_sense_classify(xr, xi, *w))
    out["host_us"] = host
    print(f"[sense-host] C=1, host us per call (least of 10 runs of 300): "
          f"{', '.join(f'{k} {v:.2f}' for k, v in host.items())}; {smi}", flush=True)


def measure(dev=None, smi: str = "") -> dict:
    """Every measurement of the module docstring."""
    dev = torch.device(dev or "cuda")
    params = reference_weights(device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {"card": smi, "calls": {}, "kernels": {}}
    measure_calls(out, dev, params, gen, smi)
    measure_kernels(out, dev, params, gen, smi)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="write the measurements here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_sense: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = measure(smi=smi.splitlines()[0])
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
