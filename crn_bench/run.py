"""Run one cell of the port's benchmark on the card and print its result line.

    python3 -m crn_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration (``crn_bench/configs/<config>.json``) and a traffic mix
(``crn_bench/traffic/<mix>.json``), which names its driver
(``crn_bench/drivers/<driver>.py``).  The driver builds the system under test
and its inputs from the seed and warms them up (set-up), drives the timed
window, and hands over what the window produced, which is compared with the
plain reference once the window has closed and the program's state is freed.

``--trace 0`` prints the cell's end-to-end metrics.  ``--trace 1`` runs two
windows: one of ``--seconds`` with the harness's spans on the host clock
alone, then one of the mix's ``trace_seconds`` under the profiler; it prints
the cell's per-layer metrics, each read by ``crn_bench/metrics/<metric>.py``
from the first window's spans (the profiler's own cost left out) or the
second's trace and the driver's counters, with the device's busy and window
seconds and a breakdown.  ``--control 1`` puts the cell's control (a lower precision, see
the drivers) in the program's place; the benchmark's own runs never do.

The last line of standard output is one JSON object; the numbers compared
and their limits are the last lines of standard error and the result's last
key.  Without a card (or with fewer than the cell asks for) the run exits
with code 2 and prints no result.  The kernel library builds into
``build/kernels/`` inside the checkout (the program's own fixed directory),
in the first run there; the result's ``build`` key says whether this run
built it and how long that took, within ``setup_s``.  Triton's and PyTorch's
extension caches are pointed at ``build/`` too.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

THREADS = 1  # host threads of torch and the numerical libraries, fixed before they load


def _environment() -> None:
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(THREADS)
    from crn_bench.harness import ROOT

    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")


def _kernels(cuda: bool) -> dict:
    """Load the port's kernel library, building it if this checkout has no
    build yet: whether this run built it, and the seconds that took."""
    if not cuda:
        return {"kernels_built": False, "seconds": 0.0}
    from cognitive_radio_network_tpu_torch.ops import _build

    built = not _build.library_path().exists()
    t0 = time.time()
    _build.load()
    return {"kernels_built": built, "seconds": time.time() - t0}


def execute(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
            control: bool = False, started: float | None = None, log=sys.stderr) -> dict:
    """Set-up, window and comparison of one cell on ``device`` (with the
    cell's control in the program's place where ``control``); the result
    line's object."""
    from crn_bench import harness

    started = time.time() if started is None else started
    bench, cell, config, traffic = harness.load_cell(workload)
    import torch

    cuda = device != "cpu"
    t_torch = time.time()
    print(f"cell {cell['name']}: seed {seed}, {seconds} s, trace {int(trace)}; host threads "
          f"{THREADS} (torch {torch.get_num_threads()}, OMP_NUM_THREADS "
          f"{os.environ.get('OMP_NUM_THREADS')})", file=log)
    print(harness.cpu_line(), file=log)
    spans = harness.Spans(on=bool(trace))
    driver = harness.driver_class(traffic)(config, traffic, seed, device, spans, control=control)
    t_setup = time.time()
    build = _kernels(cuda)
    driver.setup()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - started
    print(f"set-up s: {setup_s!r} (to torch imported {t_torch - started!r}, the driver's import "
          f"{t_setup - t_torch!r}, the kernel library {build['seconds']!r} (built in this run: "
          f"{build['kernels_built']}), the driver's set-up and warm-up "
          f"{time.time() - t_setup - build['seconds']!r})", file=log)
    if cuda:
        print("before window " + harness.gpu_line(), file=log, flush=True)

    gc.collect()
    gc.freeze()  # the set-up's objects leave the collector's generations for the window
    if trace:
        spans.items.clear()
        driver.window(seconds)  # the host spans, unprofiled
        host_spans = list(spans.items)
        print("harness spans in the untraced window (host us): " + spans.summary(), file=log)
        with harness.Profiled(spans, device) as prof:
            out = driver.window(float(traffic["trace_seconds"]))
    else:
        out = driver.window(seconds)
    if cuda:
        torch.cuda.synchronize()
    gc.unfreeze()
    memory_peak = max(torch.cuda.max_memory_allocated(i) for i in range(cell["chips"])) if cuda else 0
    if cuda:
        print("after window " + harness.gpu_line(), file=log, flush=True)
    for line in out.get("notes", []):
        print(line, file=log)

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": int(memory_peak)}
    result = {"correct": False, "attempted": int(out["attempted"]), "failed": 0}
    metrics = {}
    if trace:
        print("harness spans in the traced window (host us): " + spans.summary(), file=log)
        rec = harness.record(prof.events, spans, host_spans, driver.counters, cell, config)
        lo, hi = rec["window"]
        device_info["busy_s"] = harness.busy_us(rec, lo, hi) * 1e-6
        device_info["window_s"] = (hi - lo) * 1e-6
        for m in harness.cell_metrics(bench, cell["name"], "per_layer"):
            value = harness.metric_reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        result["breakdown"] = harness.breakdown(rec)
        del rec, prof
    else:
        for m in harness.cell_metrics(bench, cell["name"], "end_to_end"):
            value = setup_s if m["name"] == "setup_s" else out["metrics"][m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    driver.release()
    checks, failed = driver.check()
    result.update(correct=harness.checks_correct(checks) and failed == 0, failed=int(failed),
                  metrics=metrics, device=device_info)
    for k, v in getattr(driver, "info", {}).items():
        print(f"not compared: {k} {v!r}", file=log)
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v!r} (limit {lim!r})", file=log)
    result["build"] = build
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    from crn_bench import harness

    started = harness.process_start()
    _bench, cell, _config, _traffic = harness.load_cell(args.workload)
    import torch

    torch.set_num_threads(THREADS)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"crn_bench: the cell needs {cell['chips']} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 2
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                     control=bool(args.control), started=started)
    found = harness.forbidden_modules()
    if found:
        print(f"crn_bench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
