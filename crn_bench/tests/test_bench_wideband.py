"""The ``wideband64.detect`` cell on the CPU: its reference, inputs, metrics,
result line, and ``correct`` coming out false for the control and for each
fault the cell can have.

The rehearsals drive :func:`crn_bench.run.execute` on the CPU (kernel 3's
plain version) with the fleet and the call cut to 3 streams of 6 cycles; the
run on the card is the same code at the cell's 48 streams and its cycles a
call (``traffic/wideband_detect.json``).
"""

import io
import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from crn_bench import harness
from crn_bench.reference.wideband import make_capture, prototype, pu_centers, wideband_reference
from crn_bench.tests.test_bench_metrics import _kernel, _launch, _record, _span
from crn_bench.tests.test_bench_program_metrics import _canned, _records

CELL = "wideband64.detect"
SMALL_CONFIG = {"fleet": 3}
SMALL_TRAFFIC = {"cycles": 6, "kept_calls": 2}
METRICS = ["wideband_roofline", "device_idle_pct.wideband", "wideband_ops_per_call",
           "wideband_host_us"]


def rehearse(seed: int = 2**31 + 17, *, trace: bool = False, seconds: float = 0.4,
             control: bool = False) -> dict:
    """:func:`crn_bench.run.execute` of the cell on the CPU at the small sizes."""
    from crn_bench.run import execute

    load = harness.load_cell

    def small(name):
        bench, c, config, traffic = load(name)
        return bench, c, {**config, **SMALL_CONFIG}, {**traffic, **SMALL_TRAFFIC, "trace_seconds": 0.3}

    harness.load_cell = small
    try:
        return execute(CELL, seed, seconds, trace, device="cpu", control=control, log=io.StringIO())
    finally:
        harness.load_cell = load


def _config():
    return harness.load_json(harness.BENCH / "configs" / "wideband64.json")


# --- the reference and the inputs ----------------------------------------------------


def test_prototype_meets_its_description():
    h = prototype(64, 8)
    assert h.shape == (512,) and h.dtype == np.float64
    assert np.allclose(h, h[::-1], rtol=0, atol=1e-15)  # symmetric: linear phase
    assert abs(h.sum() - 1.0) < 1e-12  # unit DC gain
    assert h.argmax() in (255, 256)  # the sinc's peak in the middle
    # the Kaiser window's 70 dB: the stop band, from 1.5 channels out, 70 dB under the pass band
    resp = np.abs(np.fft.fft(h, 64 * 512))
    f = np.fft.fftfreq(64 * 512)
    assert 20 * np.log10(resp[np.abs(f) >= 1.5 / 64].max()) < -68
    # the program's taps are this prototype rounded to float32 (the reference's one departure)
    from cognitive_radio_network_tpu_torch.parallel.wideband import WidebandConfig

    taps = WidebandConfig().taps()
    assert taps.shape == (8, 64) and np.abs(taps.reshape(-1) - h).max() < 1e-8


def test_reference_continues_the_stream_across_blocks():
    wb = _config()["wideband"]
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 4 * 128 * 64, 2, generator=g)
    whole = wideband_reference(x, None, wb)
    half = 2 * 128 * 64
    first, second = wideband_reference(x[:, :half], None, wb), wideband_reference(x[:, half:], x[:, :half], wb)
    for k in whole:
        got = torch.cat([first[k], second[k]], dim=1)
        assert torch.allclose(got.double(), whole[k].double(), rtol=1e-12, atol=0), k


def test_capture_is_deterministic_per_seed_and_occupies_channels():
    cfg = _config()

    def capture(seed):
        gen = torch.Generator().manual_seed(seed)
        return make_capture(gen, 2, 6, cfg, pu_centers(gen, cfg))

    a, b, c = capture(2**31 + 5), capture(2**31 + 5), capture(2**31 + 6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (2, 6 * 128 * 64, 2) and a.dtype == torch.float32
    occ = wideband_reference(a, None, cfg["wideband"])["occupied"]
    assert 0.02 < float(occ.double().mean()) < 0.6  # busy channels, and free ones
    gen = torch.Generator().manual_seed(1)
    centers = pu_centers(gen, cfg)
    assert centers[:3] == cfg["scene"]["pu_channels_hz"] and len(centers) == 3 + cfg["scene"]["extra_pus"]
    edge = cfg["sample_rate_hz"] / 2 - cfg["scene"]["pu_bandwidth_hz"] / 2
    assert all(abs(f - cfg["center_hz"]) <= edge for f in centers)


# --- the metrics ---------------------------------------------------------------------


def test_roofline_idle_and_ops_on_a_canned_trace():
    read = harness.metric_reader("wideband_roofline")
    c = {"streams": 48, "rows": 20480, "block_len": 128, "channels": 64, "taps": 8}
    mod = read.__globals__
    nbytes = mod["call_bytes"](48, 20480, 128, 64, 8)
    assert nbytes == 48 * 20480 * 64 * 8 + 2 * 48 * 2 * 8 * 64 * 4 + 8 * 64 * 4 + 64 * 4 + 48 * 160 * (64 * 4 + 4 + 64)
    assert mod["call_flops"](48, 20480, 64, 8) == 48 * 20480 * 64 * (32 + 30 + 3)
    least = mod["least_seconds"](48, 20480, 128, 64, 8)
    assert least == pytest.approx(nbytes / 3.35e12)  # bound by bytes: 0.150 ms
    # two calls: a kernel and a copy launched inside each span; a launch outside any span
    ev = [_span("wideband_call", 1100, 50), _launch(1110, 1), _kernel(1120, 200, 1, "fused_wideband_kernel"),
          _launch(1120, 2), _kernel(1320, 10, 2, "Memcpy DtoD", "gpu_memcpy"),
          _span("wideband_call", 1400, 50), _launch(1410, 3), _kernel(1420, 190, 3, "fused_wideband_kernel"),
          _launch(1700, 4), _kernel(1710, 100, 4)]
    assert read(_record(ev, counters=c)) == pytest.approx(100 * 2 * least / 400e-6)
    assert read(_record([], counters=c)) is None
    idle = harness.metric_reader("device_idle_pct.wideband")
    assert idle(_record(ev)) == pytest.approx(100 * (1 - 500 / 1000))
    ops = harness.metric_reader("wideband_ops_per_call")
    prog = [_span("wideband.call", 1105, 40), _span("wideband.call", 1405, 40)]
    assert ops(_record(ev + prog)) == pytest.approx(1.5)  # 2 operations, then 1; the last launch in neither
    assert ops(_record(ev)) is None  # a program without the span


def test_host_us_reads_the_programs_records(monkeypatch, capsys):
    from cognitive_radio_network_tpu_torch.utils import profiling

    parts = lambda t: [("wideband.place", t, t + 5, {}, 0), ("wideband.energy", t + 5, t + 40, {}, 0),  # noqa: E731
                       ("wideband.decide", t + 40, t + 70, {}, 0), ("wideband.carry", t + 70, t + 75, {}, 0)]
    counts = {"wideband.cycles": 7680, "wideband.carried_streams": 48}
    records = _records(("wideband.call", 1110, 1190, counts, parts(1110)),
                       ("wideband.call", 1410, 1450, counts, parts(1410)),
                       ("wideband.call", 1800, 1900, counts, parts(1800)),  # outside the harness's spans
                       ("wideband.call", 2100, 2150, counts, parts(2100)))  # after the traced window
    _canned(monkeypatch, records)
    read = harness.metric_reader("wideband_host_us")
    rec = _record([_span("wideband_call", 1100, 100), _span("wideband_call", 1400, 60)])
    # every call in the traced window, whether or not the profiler kept its harness span
    assert read(rec) == pytest.approx((80 + 40 + 100) / 3)
    err = capsys.readouterr().err
    said = dict(kv.rsplit(" ", 1) for kv in err.split("host us a call ")[1].replace(";", ",").split(", "))
    assert float(said["wideband.energy"]) == pytest.approx(35.0)
    assert float(said["wideband.carried_streams"].strip()) == 48.0
    _canned(monkeypatch, [])
    assert read(rec) is None
    monkeypatch.delattr(profiling, "calls")  # the parent: no tracer at all
    assert read(rec) is None


# --- runs ----------------------------------------------------------------------------


def test_result_line():
    r = rehearse(2**31 + 99)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"detect_msps", "setup_s"}
    assert set(r["checks"]) == {"energy_gap", "noise_gap", "decision_mismatch", "repeat_mismatch"}
    assert list(r)[-1] == "checks"
    json.dumps(r)


def test_traced_run_reads_the_programs_spans():
    r = rehearse(7, trace=True, seconds=0.2)
    assert r["correct"] is True
    # the CPU trace has no device records: the device metrics stay silent, the host one reads
    assert set(r["metrics"]) == {"wideband_host_us"}
    assert r["metrics"]["wideband_host_us"]["value"] > 0


def test_control_is_not_correct():
    r = rehearse(control=True)
    assert r["correct"] is False
    assert r["checks"]["energy_gap"]["value"] > r["checks"]["energy_gap"]["limit"]


def _fault(kind):
    from cognitive_radio_network_tpu_torch.parallel import wideband

    orig = wideband.make_wideband_fn

    def make(cfg, *, continuous=False, **kw):
        fn = orig(cfg, continuous=continuous and kind != "from_rest", **kw)
        state = {"calls": 0, "last": None}

        def broken(planes, **k):
            state["calls"] += 1
            if kind == "left_out" and state["calls"] % 3 == 0:  # the previous call's decisions again
                return state["last"]
            out = dict(fn(planes, **k))
            if kind == "altered":  # one decision altered where it is produced
                occ = out["occupied"].clone()
                occ[0, 0, 0] = ~occ[0, 0, 0]
                out["occupied"] = occ
            if kind == "altered_once" and state["calls"] == 5:  # a middle cycle of one later call
                occ = out["occupied"].clone()
                occ[1, occ.shape[1] // 2, 3] = ~occ[1, occ.shape[1] // 2, 3]
                out["occupied"] = occ
            state["last"] = out
            return out

        broken.reset = fn.reset
        return broken

    return wideband, make


@pytest.mark.parametrize("kind", ["from_rest", "altered", "altered_once", "left_out"])
def test_faults_are_not_correct(kind, monkeypatch):
    mod, make = _fault(kind)
    monkeypatch.setattr(mod, "make_wideband_fn", make)
    # the one altered call is the window's third: a window long enough for it on a loaded machine
    r = rehearse(seconds=2.0 if kind == "altered_once" else 0.6)
    assert r["correct"] is False
    assert any(v["value"] > v["limit"] for v in r["checks"].values())


def test_nothing_loads_jax():
    code = textwrap.dedent("""
        import sys
        import crn_bench.reference.wideband, crn_bench.drivers.wideband_detect
        from crn_bench.tests.test_bench_wideband import rehearse
        assert rehearse(3)["correct"]
        from crn_bench import harness
        for name in ("wideband_roofline", "device_idle_pct.wideband", "wideband_ops_per_call",
                     "wideband_host_us"):
            harness.metric_reader(name)
        tops = {m.split(".", 1)[0] for m in sys.modules}
        assert "cognitive_radio_network_tpu_torch" in tops
        print(sorted(tops & {"jax", "jaxlib", "flax", "cognitive_radio_network_tpu"}))
    """)
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program_or_jax():
    code = ("import sys, crn_bench.reference.wideband; "
            "print(sorted({m.split('.', 1)[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'cognitive_radio_network_tpu', 'cognitive_radio_network_tpu_torch'}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip() == "[]"


def test_the_cell_is_in_the_benchmark():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert cell == {**cell, "config": "wideband64", "traffic": "wideband_detect", "chips": 1}
    assert {m["name"] for m in harness.cell_metrics(bench, CELL, "end_to_end")} == {"detect_msps", "setup_s"}
    assert {m["name"] for m in harness.cell_metrics(bench, CELL, "per_layer")} == set(METRICS)
