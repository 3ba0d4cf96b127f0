"""What every cell shares: the benchmark's files, the host's facts, spans,
the profiler's trace and the arithmetic read from it, and the result line.

Nothing here imports the program or torch at module level; the run imports
torch after it has fixed the host's thread counts.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import platform
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]  # the checkout
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cognitive_radio_network_tpu")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
FP32_FLOPS = 67e12  # H100 SXM float32 rate outside the tensor cores
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


# ---------------------------------------------------------------- files


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_cell(name: str) -> tuple[dict, dict, dict, dict]:
    """(benchmark, cell, config, traffic) for a cell of BENCHMARK.json."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[cell["config"]]["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    return bench, cell, config, traffic


def driver_class(traffic: dict):
    """The driver a traffic file names: ``crn_bench/drivers/<driver>.py``'s ``Driver``."""
    return importlib.import_module(f"crn_bench.drivers.{traffic['driver']}").Driver


def metric_reader(name: str):
    """``read(record)`` of ``crn_bench/metrics/<name>.py`` (the name may hold dots)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"crn_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The cell's ``end_to_end`` or ``per_layer`` metrics: those whose
    ``workloads`` name it, or that name none."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


# ---------------------------------------------------------------- host


def process_start() -> float:
    """The process's start on the ``time.time()`` clock: its age from Linux's
    /proc (start in clock ticks after boot, to 10 ms) against the boot clock;
    the import of this module where that is missing."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
        return time.time() - age
    except (OSError, IndexError, ValueError, AttributeError):
        return _IMPORTED


_IMPORTED = time.time()


def cpu_line() -> str:
    model = platform.machine() or "unknown"
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith(("model name", "CPU part")):
                model += ", " + line.split(":", 1)[1].strip()
                break
    except OSError:
        pass
    return f"cpu: {model}; {os.cpu_count()} cores, {len(os.sched_getaffinity(0))} usable"


def gpu_line() -> str:
    """nvidia-smi's name, clocks, power and limit of the cards, on one line."""
    q = "name,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return "nvidia-smi: " + " | ".join(out.stdout.strip().splitlines())
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: unavailable ({e.__class__.__name__})"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


# ---------------------------------------------------------------- spans


class Spans:
    """Host spans around the harness's calls into the program: each a
    (name, t0, t1) on the host clock and, while ``profiled``, a
    ``record_function`` range in the profiler's trace too.  Off, a span
    costs nothing; on and unprofiled, two reads of the clock."""

    _OFF = contextlib.nullcontext()

    def __init__(self, on: bool):
        self.on = on
        self.profiled = False
        self.items: list[tuple[str, float, float]] = []

    def __call__(self, name: str):
        if not self.on:
            return self._OFF
        return self._traced(name) if self.profiled else self._timed(name)

    @contextlib.contextmanager
    def _timed(self, name: str):
        t0 = time.perf_counter()
        yield
        self.items.append((name, t0, time.perf_counter()))

    @contextlib.contextmanager
    def _traced(self, name: str):
        import torch

        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.items.append((name, t0, time.perf_counter()))

    def summary(self) -> str:
        """Count, mean and largest host us of each span name."""
        by: dict[str, list[float]] = {}
        for n, t0, t1 in self.items:
            by.setdefault(n, []).append((t1 - t0) * 1e6)
        return "; ".join(f"{n} x{len(d)} mean {sum(d) / len(d):.1f} max {max(d):.1f}"
                         for n, d in by.items())


@contextlib.contextmanager
def wrapped(module, attr: str, spans: Spans, name: str):
    """Replace ``module.attr`` by a wrapper that opens the span ``name``, for the block."""
    orig = getattr(module, attr)

    def wrapper(*args, **kwargs):
        with spans(name):
            return orig(*args, **kwargs)

    setattr(module, attr, wrapper)
    try:
        yield
    finally:
        setattr(module, attr, orig)


# ---------------------------------------------------------------- trace


class Profiled:
    """The profiler (host and card) around the traced window, whose span
    ``crn_window`` ties the trace's clock to the host's."""

    WINDOW = "crn_window"

    def __init__(self, spans: Spans, device: str = "cuda"):
        import torch

        self.spans, self.device = spans, device
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device != "cpu":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.events: list[dict] = []

    def __enter__(self):
        import torch

        self.spans.profiled = True
        self.prof.__enter__()
        # the tracer's own start-up (its first device record) before the window
        torch.ones(1, device=self.device).add_(1).cpu()
        self.spans.items.clear()  # the window's spans only, not the set-up's
        self._span = self.spans(self.WINDOW)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        if self.device != "cpu":
            torch.cuda.synchronize()
        self._span.__exit__(*exc)
        self.prof.__exit__(*exc)
        self.spans.profiled = False
        if exc[0] is None:
            fd, path = tempfile.mkstemp(suffix=".json")  # under TMPDIR
            os.close(fd)
            try:
                self.prof.export_chrome_trace(path)
                self.events = [e for e in load_json(Path(path))["traceEvents"] if e.get("ph") == "X"]
            finally:
                os.unlink(path)
        return False


def record(events: list[dict], spans: Spans, host_spans: list, counters: dict, cell: dict,
           config: dict) -> dict:
    """What a per-layer metric reads: the traced window's complete events and
    its spans, the trace's window and the offset that maps the host clock
    onto the trace's (us), the driver's counters of the traced window, and
    ``spans``: the harness's spans on the host clock from the untraced window
    that ran just before it (the profiler slows every host call it records)."""
    win = next(e for e in events if e.get("cat") == "user_annotation" and e["name"] == Profiled.WINDOW)
    host = next((t0, t1) for n, t0, t1 in spans.items if n == Profiled.WINDOW)
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    return {"events": events, "spans": host_spans, "window": (w0, w1),
            "offset_us": w0 - host[0] * 1e6, "counters": counters, "cell": cell, "config": config}


def device_ops(rec: dict) -> list[dict]:
    return [e for e in rec["events"] if e.get("cat") in DEVICE_CATS]


def intervals(ops: list[dict], lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of the operations' intervals, clipped to [lo, hi], sorted."""
    iv = sorted((max(float(e["ts"]), lo), min(float(e["ts"]) + float(e["dur"]), hi)) for e in ops)
    out: list[list[float]] = []
    for a, b in iv:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_us(rec: dict, lo: float, hi: float) -> float:
    return sum(b - a for a, b in intervals(device_ops(rec), lo, hi))


def idle_pct(rec: dict, windows: list[tuple[float, float]] | None = None) -> float | None:
    """Idle share (%) of the device over the windows (trace us; the traced window by default)."""
    windows = windows or [rec["window"]]
    total = sum(b - a for a, b in windows)
    if total <= 0 or not device_ops(rec):
        return None
    return 100.0 * (1.0 - sum(busy_us(rec, a, b) for a, b in windows) / total)


def span_ops(rec: dict, label: str) -> list[list[dict]]:
    """For each ``label`` span in the trace, the device operations launched
    inside it (a launch on the span's thread within it, joined by correlation id)."""
    events = rec["events"]
    device: dict = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in DEVICE_CATS and corr is not None:
            device.setdefault(corr, []).append(e)
    launches = sorted((float(e["ts"]), e["pid"], e["tid"], e["args"]["correlation"]) for e in events
                      if e.get("cat") in LAUNCH_CATS and e.get("args", {}).get("correlation") in device)
    out = []
    for s in events:
        if s.get("cat") != "user_annotation" or s["name"] != label:
            continue
        t0, t1 = float(s["ts"]), float(s["ts"]) + float(s["dur"])
        out.append([d for ts, pid, tid, c in launches
                    if t0 <= ts <= t1 and (pid, tid) == (s["pid"], s["tid"]) for d in device[c]])
    return out


def span_calls(rec: dict, label: str, which) -> list[int]:
    """For each ``label`` span, the runtime calls on its thread inside it whose name ``which`` accepts."""
    events = rec["events"]
    calls = [(float(e["ts"]), e["pid"], e["tid"]) for e in events
             if e.get("cat") in LAUNCH_CATS and which(e["name"])]
    out = []
    for s in events:
        if s.get("cat") != "user_annotation" or s["name"] != label:
            continue
        t0, t1 = float(s["ts"]), float(s["ts"]) + float(s["dur"])
        out.append(sum(1 for ts, pid, tid in calls if t0 <= ts <= t1 and (pid, tid) == (s["pid"], s["tid"])))
    return out


def breakdown(rec: dict) -> dict:
    """The 10 device operations that took most time (s, summed by name) and
    the 10 longest idle gaps in the window, each named by the innermost
    harness span open on the host when it began."""
    lo, hi = rec["window"]
    by_name: dict[str, float] = {}
    for e in device_ops(rec):
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"]) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    busy = intervals(device_ops(rec), lo, hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    spans = [(float(s["ts"]), float(s["ts"]) + float(s["dur"]), s["name"]) for s in rec["events"]
             if s.get("cat") == "user_annotation" and s["name"] != Profiled.WINDOW]

    def name_at(t: float) -> str:
        open_ = [(b - a, n) for a, b, n in spans if a <= t < b]
        return min(open_)[1] if open_ else "harness (no span open)"

    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[name_at(t), d * 1e-6] for d, t in gaps]}


# ---------------------------------------------------------------- result


def checks_correct(checks: dict[str, tuple[float, float]]) -> bool:
    """Every number compared is at most its limit (a missing number fails)."""
    return all(v == v and v <= lim for v, lim in checks.values())
