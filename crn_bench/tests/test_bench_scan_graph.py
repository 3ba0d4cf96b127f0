"""``scan_graph_hit_pct.rx``: the share of ``StreamReceiver.process`` calls
inside the harness's ``process`` spans whose block scan replayed a CUDA graph,
on canned program records; None on a program that counts no scan graphs."""

import pytest

from crn_bench import harness
from crn_bench.tests.test_bench_metrics import _record, _span
from crn_bench.tests.test_bench_program_metrics import _canned, _records
from cognitive_radio_network_tpu_torch.utils import profiling

NAME = "scan_graph_hit_pct.rx"
EVENTS = [_span("process", 1100, 100), _span("process", 1300, 100), _span("process", 1500, 100)]


def _call(t0, scan_counts=None):
    """An ``rx.process`` call at ``t0`` us; with ``scan_counts``, one that opened ``rx.scan``."""
    kids = [("rx.stage", t0, t0 + 2, {}, 0)]
    if scan_counts is not None:
        kids += [("rx.upload", t0 + 2, t0 + 3, {}, 0), ("rx.scan", t0 + 3, t0 + 9, scan_counts, 0),
                 ("rx.scan_read", t0 + 9, t0 + 12, {}, 0)]
    return ("rx.process", t0, t0 + 20, {}, kids)


def test_replays_over_the_calls_that_scanned(monkeypatch):
    _canned(monkeypatch, _records(
        _call(1110, {"rx.scan_graph_captures": 1}),
        _call(1150, {"rx.scan_graph_replays": 1}),
        _call(1310),  # too short to scan: not a base
        _call(1320, {"rx.scan_graph_replays": 1}),
        _call(1510, {"rx.scan_graph_replays": 1}),
        _call(1700, {"rx.scan_graph_replays": 1}),  # after the window (no harness span): left out
    ))
    assert harness.metric_reader(NAME)(_record(EVENTS)) == pytest.approx(100.0 * 3 / 4)


@pytest.mark.parametrize("counts", [{}, {"rx.scan_graph_captures": 1}])
def test_all_or_none_replayed(monkeypatch, counts):
    """A window of captures alone reads 0; of replays alone, 100."""
    _canned(monkeypatch, _records(_call(1110, counts or {"rx.scan_graph_replays": 1}),
                                  _call(1310, counts or {"rx.scan_graph_replays": 1})))
    assert harness.metric_reader(NAME)(_record(EVENTS)) == (0.0 if counts else 100.0)


def test_none_without_scan_graphs(monkeypatch):
    """The CPU or a program without scan graphs (its scans count neither
    counter), no scan in the window, a tracer that recorded nothing, no tracer."""
    read = harness.metric_reader(NAME)
    _canned(monkeypatch, _records(_call(1110, {}), _call(1310, {})))
    assert read(_record(EVENTS)) is None
    _canned(monkeypatch, _records(_call(1110), _call(1310)))
    assert read(_record(EVENTS)) is None
    _canned(monkeypatch, [])
    assert read(_record(EVENTS)) is None
    monkeypatch.delattr(profiling, "calls")
    assert read(_record(EVENTS)) is None
