"""Each per-layer metric's arithmetic on a canned trace."""

import pytest

from crn_bench import harness
from crn_bench.harness import Profiled


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def _launch(ts, corr, name="cudaLaunchKernel", tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 2, "pid": 1, "tid": tid,
            "args": {"correlation": corr}}


def _kernel(ts, dur, corr, name="fused_sense_classify_kernel", cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7,
            "args": {"correlation": corr}}


def _record(events, spans=(), counters=None):
    # the window runs from trace us 1000 to 2000; host second 1.0 is trace us 1000
    events = [_span(Profiled.WINDOW, 1000, 1000)] + list(events)
    return {"events": events, "spans": list(spans), "window": (1000.0, 2000.0), "offset_us": 0.0,
            "counters": counters or {}, "cell": {}, "config": {}}


def test_sense_roofline():
    read = harness.metric_reader("sense_roofline")
    c = {"cycles": 4096, "averaging": 10, "fft_length": 512, "itemsize": 4}
    least = read.__globals__["least_seconds"](4096, 10, 512, 4)
    assert least == pytest.approx(0.05264e-3, rel=1e-3)  # bytes bound, 176 MB over 3.35 TB/s
    # two calls, each one kernel of 100 us and a 5 us copy launched inside the span
    ev = [_span("sense_call", 1100, 50), _launch(1110, 1), _kernel(1120, 100, 1),
          _launch(1120, 2, "cudaMemcpyAsync"), _kernel(1220, 5, 2, "Memcpy DtoH", "gpu_memcpy"),
          _span("sense_call", 1300, 50), _launch(1310, 3), _kernel(1320, 100, 3),
          _launch(1400, 4), _kernel(1500, 100, 4)]  # launched outside any span: not counted
    assert read(_record(ev, counters=c)) == pytest.approx(100 * 2 * least / 205e-6)
    assert read(_record([], counters=c)) is None


def test_idle_shares():
    ev = [_kernel(1000, 100, 1), _kernel(1050, 100, 2), _kernel(1900, 200, 3)]  # union 150 + 100 in window
    assert harness.metric_reader("device_idle_pct.detect")(_record(ev)) == pytest.approx(75.0)
    assert harness.metric_reader("device_idle_pct.rx")(_record(ev)) == pytest.approx(75.0)
    assert harness.metric_reader("device_idle_pct.rx")(_record([])) is None
    # quiet periods: host seconds [1.0, 1.2e-4 later] and [1.5, ...]: trace us 1000-1120, 1500-1600
    bursts = {"bursts": [(1000e-6, 1120e-6), (1500e-6, 1600e-6)]}
    ev = [_kernel(1000, 60, 1), _kernel(1550, 50, 2)]
    assert harness.metric_reader("device_idle_pct.decision")(_record(ev, counters=bursts)) == pytest.approx(
        100 * (1 - 110 / 220))


def test_receiver_counts():
    ev = [_span("process", 1100, 100), _launch(1110, 1), _kernel(1120, 5, 1), _launch(1120, 2),
          _kernel(1130, 5, 2), _launch(1150, 3, "cudaMemcpyAsync"),
          _kernel(1160, 2, 3, "Memcpy DtoH", "gpu_memcpy"),
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 1170, "dur": 5,
           "pid": 1, "tid": 1, "args": {}},
          _span("process", 1300, 100), _launch(1310, 4), _kernel(1320, 5, 4)]
    # the untraced window's spans: two process calls, 4 ms of decode in them
    spans = [("process", 1.0, 1.01), ("decode_bits", 1.001, 1.004), ("process", 2.0, 2.01),
             ("decode_bits", 2.001, 2.002)]
    rec = _record(ev, spans, counters={"process_calls": 2})
    assert harness.metric_reader("device_ops_per_block.rx")(rec) == pytest.approx(2.0)
    assert harness.metric_reader("host_syncs_per_block.rx")(rec) == pytest.approx(0.5)
    assert harness.metric_reader("decode_ms_per_block.rx")(rec) == pytest.approx(2.0)


def test_sense_call_us_and_breakdown():
    spans = [("sense_call", 1.0, 1.0001), ("sense_call", 2.0, 2.0003), ("read_decisions", 2.0, 3.0)]
    assert harness.metric_reader("sense_call_us.decision")(_record([], spans)) == pytest.approx(200.0)
    ev = [_span("process", 1000, 500), _kernel(1100, 100, 1, "k1"), _kernel(1300, 50, 2, "k2"),
          _kernel(1400, 100, 3, "k1")]
    b = harness.breakdown(_record(ev))
    assert b["device_ops"][0] == ["k1", pytest.approx(200e-6)]
    assert b["idle_gaps"][0] == ["harness (no span open)", pytest.approx(500e-6)]  # 1500-2000
    assert b["idle_gaps"][1] == ["process", pytest.approx(100e-6)]  # 1000-1100
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
