"""The device-API cells (``drivers/rx_device.py``): ``gateway48.rx_batch`` (a
``StreamBank`` of every stream, one step a medium block) and
``eight_node.rx_bulk`` (``feed_device`` a stream, round robin).

Whole runs on the CPU at small sizes (the kernels' plain versions): a sound
run is correct, the control is not, and neither is a run whose bank leaves
out frames of one stream, alters a payload byte of one stream or hands one
stream's frames to another (through ``feed_device`` for the round robin).
A port without ``StreamBank`` fails the batch mix in its set-up.  The six
per-layer metrics read canned traces and program records, and read None
where the program has no step spans.
"""

import collections
import io

import numpy as np
import pytest

from crn_bench import harness
from crn_bench.tests.test_bench_metrics import _kernel, _launch, _record, _span
from cognitive_radio_network_tpu_torch.utils import profiling

CHEAP_PHY = {"mod": "qam4", "fec0": "h128", "fec1": "none"}  # eight_node's link PHY
SMALL = {
    # three of the 48 links
    "gateway48.rx_batch": ({"links": 3}, {"min_tape_samples": 40_000, "trace_seconds": 0.5}),
    "eight_node.rx_bulk": ({"links": 3}, {"min_tape_samples": 60_000, "block_samples": 20_000,
                                          "max_frames_per_block": 12, "max_lag": 2, "fetch_group": 2,
                                          "trace_seconds": 0.5}),
}
CELLS = tuple(SMALL)


@pytest.fixture(autouse=True)
def _one_thread():
    """One host thread, as ``crn_bench.run`` fixes it, so that parallel test
    workers do not crowd each other out of the window."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rehearse(cell, *, trace=False, control=False, seconds=0.5, cheap=False):
    """:func:`crn_bench.run.execute` on the CPU with the cell cut to SMALL;
    ``cheap`` gives the links eight_node's PHY, whose decode needs no Viterbi
    loop (the plain loop of v27 + v27 takes about a second a step here)."""
    from crn_bench.run import execute

    load = harness.load_cell
    cut_config, cut_traffic = SMALL[cell]

    def small(name):
        bench, c, config, traffic = load(name)
        links = config["links"][: cut_config["links"]]
        if cheap:
            links = [dict(link, phy=dict(link["phy"], **CHEAP_PHY)) for link in links]
        return bench, c, dict(config, links=links), {**traffic, **cut_traffic}

    harness.load_cell = small
    try:
        return execute(cell, 2**31 + 29, seconds, trace, device="cpu", control=control, log=io.StringIO())
    finally:
        harness.load_cell = load


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = rehearse(cell)
    assert r["correct"] is True and r["attempted"] > 0
    assert set(r["metrics"]) == {"rx_frames_per_s", "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    r = rehearse(cell, control=True, cheap=True)
    assert r["correct"] is False
    assert any(v["value"] > v["limit"] for v in r["checks"].values())


def _fault(kind, out, armed):
    """``out``: per stream, the frames a call handed back; broken for stream 1
    (``armed``: the window has begun and no frame has been dropped yet)."""
    if kind == "dropped":  # the first frame of stream 1 that the window hands back, left out
        if armed[0] and out[1]:
            out[1] = out[1][1:]
            armed[0] = False
    elif kind == "altered":  # a payload byte of each of stream 1's frames altered where it is produced
        for f in out[1]:
            f["payload"] = f["payload"].copy()
            f["payload"][0] ^= 1
    else:  # stream 0's and stream 1's frames handed to each other
        out[0], out[1] = out[1], out[0]
    return out


def _arm(monkeypatch) -> list:
    """A flag the driver's window sets as it begins."""
    from crn_bench.drivers import rx_device

    armed, window = [False], rx_device.Driver.window

    def arming(self, seconds):
        armed[0] = True
        return window(self, seconds)

    monkeypatch.setattr(rx_device.Driver, "window", arming)
    return armed


@pytest.mark.parametrize("kind", ["dropped", "altered", "swapped"])
def test_bank_faults_are_not_correct(kind, monkeypatch):
    from cognitive_radio_network_tpu_torch.phy.stream import StreamBank

    feed, flush = StreamBank.feed, StreamBank.flush
    armed = _arm(monkeypatch)
    monkeypatch.setattr(StreamBank, "feed", lambda self, *a, **kw: _fault(kind, feed(self, *a, **kw), armed))
    monkeypatch.setattr(StreamBank, "flush", lambda self: _fault(kind, flush(self), armed))
    r = rehearse("gateway48.rx_batch", cheap=True)
    assert r["correct"] is False and r["failed"] > 0


@pytest.mark.parametrize("kind", ["dropped", "altered"])
def test_round_robin_faults_are_not_correct(kind, monkeypatch):
    """The first two faults through ``feed_device``, on the first receiver
    fed (the first the window feeds too)."""
    from cognitive_radio_network_tpu_torch.phy.stream import StreamReceiver

    feed, flush = StreamReceiver.feed_device, StreamReceiver.flush
    first, armed = [], _arm(monkeypatch)

    def broken(call):
        def fn(self, *a, **kw):
            frames = call(self, *a, **kw)
            first[:] = first or [self]
            return _fault(kind, [[], frames], armed)[1] if self is first[0] else frames
        return fn

    monkeypatch.setattr(StreamReceiver, "feed_device", broken(feed))
    monkeypatch.setattr(StreamReceiver, "flush", broken(flush))
    r = rehearse("eight_node.rx_bulk")
    assert r["correct"] is False and r["failed"] > 0


def test_batch_mix_fails_in_setup_without_a_bank(monkeypatch):
    from cognitive_radio_network_tpu_torch.phy import stream

    monkeypatch.delattr(stream, "StreamBank")
    with pytest.raises(RuntimeError, match="no StreamBank"):
        rehearse("gateway48.rx_batch")


def test_traced_run_reads_the_program_metrics():
    r = rehearse("eight_node.rx_bulk", trace=True)
    assert r["correct"] is True
    # the CPU has no device trace: the span and counter metrics only
    assert {"step_host_us.step", "fetch_wait_us.step", "spec_hit_pct.step"} <= set(r["metrics"])
    assert r["metrics"]["spec_hit_pct.step"]["value"] == 100.0


# ---------------------------------------------------------------- metrics on canned records


def _records(*calls):
    """Program records of top-level calls (name, t0 us, t1 us, counts)."""
    return [{"name": name, "index": i, "parent": None, "call": i, "t0": t0 * 1e-6, "t1": t1 * 1e-6,
             "counts": counts} for i, (name, t0, t1, counts) in enumerate(calls)]


STEPS = _records(
    ("rx.step", 1100, 1140, {"rx.step_streams": 48, "rx.step_candidates": 768}),
    ("rx.step_fetch", 1150, 1160, {"rx.step_accepted": 40, "rx.step_spec_misses": 2}),
    ("rx.step", 1200, 1220, {"rx.step_streams": 48, "rx.step_candidates": 768}),
    ("rx.step_fetch", 1230, 1250, {"rx.step_accepted": 38}),
    ("rx.step", 2100, 2900, {}),  # after the traced window: left out
    ("rx.step_fetch", 2950, 2990, {"rx.step_accepted": 10, "rx.step_spec_misses": 10}),
)
WANT = {"step_host_us.step": (40 + 20) / 2, "fetch_wait_us.step": (10 + 20) / 2,
        "spec_hit_pct.step": 100.0 * (78 - 2) / 78}


def _canned(monkeypatch, records):
    monkeypatch.setattr(profiling, "_ring", collections.deque(records, maxlen=len(records) or 1))


@pytest.mark.parametrize("name", sorted(WANT))
def test_reads_the_programs_step_records(monkeypatch, name):
    _canned(monkeypatch, STEPS)
    assert harness.metric_reader(name)(_record([])) == pytest.approx(WANT[name])
    _canned(monkeypatch, [])  # a tracer that recorded nothing
    assert harness.metric_reader(name)(_record([])) is None
    monkeypatch.delattr(profiling, "calls")  # a program with no tracer at all
    assert harness.metric_reader(name)(_record([])) is None


EXTRACT = "void (anonymous namespace)::extract_window_sets_kernel<long>(...)"
STEP_EVENTS = [
    _span("rx.step", 1100, 40), _launch(1105, 1), _kernel(1110, 4, 1, EXTRACT),
    _launch(1110, 2), _kernel(1120, 6, 2, "elementwise"), _launch(1115, 3), _kernel(1130, 10, 3, EXTRACT),
    _span("rx.step", 1200, 20), _launch(1201, 4), _kernel(1210, 4, 4, EXTRACT), _launch(1202, 5),
    _kernel(1215, 10, 5, EXTRACT),
    _span("rx.step_fetch", 1230, 20), _launch(1231, 6), _kernel(1240, 50, 6, EXTRACT),  # a fallback's
]


def test_step_ops_per_call():
    read = harness.metric_reader("step_ops_per_call.step")
    assert read(_record(STEP_EVENTS)) == pytest.approx((3 + 2) / 2)
    assert read(_record([_span("feed", 1100, 40), _launch(1105, 1), _kernel(1110, 4, 1)])) is None


def _covered(offsets, n, wlens):
    marks = np.zeros(n + 1, np.int64)
    for w in wlens:
        s = np.clip(offsets, 0, max(n - w, 0))
        np.add.at(marks, s, 1)
        np.add.at(marks, np.minimum(s + w, n), -1)
    return int((np.cumsum(marks[:n]) > 0).sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_bytes_counts_each_distinct_sample_once(seed):
    gather_bytes = harness.metric_reader("extract_roofline.step").__globals__["gather_bytes"]
    rng = np.random.default_rng(seed)
    n = int(rng.integers(500, 5000))
    offsets = rng.integers(-50, n + 50, int(rng.integers(1, 40)))
    offsets[:2] = offsets[0]  # repeated candidates
    wlens = tuple(int(w) for w in rng.integers(1, 700, int(rng.integers(1, 4))))
    want = 8 * len(offsets) * sum(wlens) + 8 * _covered(offsets, n, wlens) + 8 * len(offsets)
    assert gather_bytes(offsets, n, wlens) == want
    assert gather_bytes(np.zeros(0, np.int64), n, wlens) == 0


def test_extract_roofline_over_the_step_launches():
    read = harness.metric_reader("extract_roofline.step")
    gather_bytes = read.__globals__["gather_bytes"]
    gathers = [(np.array([0, 100, 5000]), 20000, (160,)), (np.array([0, 100, 5000]), 20000, (688, 4864)),
               (np.array([7, 900]), 20000, (160,)), (np.array([7, 900]), 20000, (688, 4864))]
    least = sum(gather_bytes(*g) for g in gathers) / harness.HBM_BYTES_PER_S
    # four launches inside rx.step of 4 + 10 + 4 + 10 us; the fallback's inside rx.step_fetch is not read
    want = 100.0 * (least / 4) / (28e-6 / 4)
    assert read(_record(STEP_EVENTS, counters={"extract_gathers": gathers})) == pytest.approx(want)
    assert read(_record(STEP_EVENTS, counters={})) is None
    assert read(_record([_span("feed", 1100, 40)], counters={"extract_gathers": gathers})) is None


def test_device_idle_share_of_the_step_cells():
    read = harness.metric_reader("device_idle_pct.step")
    assert read(_record([_kernel(1000, 100, 1), _kernel(1050, 100, 2), _kernel(1900, 200, 3)])) == \
        pytest.approx(100.0 * (1 - 250 / 1000))
    assert read(_record([])) is None
