"""``decode_graph_hit_pct.rx``: the share of the frame groups decoded in
``StreamReceiver.process`` calls inside the harness's ``process`` spans that
replayed a CUDA graph, on canned program records; None on a program that
counts no decode graphs."""

import pytest

from crn_bench import harness
from crn_bench.tests.test_bench_metrics import _record, _span
from crn_bench.tests.test_bench_program_metrics import _canned, _records
from cognitive_radio_network_tpu_torch.utils import profiling

NAME = "decode_graph_hit_pct.rx"
EVENTS = [_span("process", 1100, 100), _span("process", 1300, 100), _span("process", 1500, 100)]


def _call(t0, decode_counts=None):
    """An ``rx.process`` call at ``t0`` us that scanned; with ``decode_counts``,
    one whose ``rx.decode`` counted them."""
    kids = [("rx.stage", t0, t0 + 2, {}, 0), ("rx.scan", t0 + 3, t0 + 9, {"rx.scan_graph_replays": 1}, 0),
            ("rx.resolve", t0 + 9, t0 + 10, {}, 0)]
    if decode_counts is not None:
        kids += [("rx.decode", t0 + 10, t0 + 15, decode_counts, 0),
                 ("rx.decode_read", t0 + 15, t0 + 18, {}, 0)]
    return ("rx.process", t0, t0 + 20, {}, kids)


def test_replays_over_the_groups_decoded(monkeypatch):
    _canned(monkeypatch, _records(
        _call(1110, {"rx.decode_graph_captures": 1}),
        _call(1150, {"rx.decode_graph_replays": 2}),  # two configs in one call
        _call(1310),  # no frame accepted: no group
        _call(1320, {"rx.decode_graph_replays": 1, "rx.decode_graph_eager": 1}),
        _call(1510, {"rx.decode_graph_replays": 1}),
        _call(1700, {"rx.decode_graph_eager": 5}),  # after the window (no harness span): left out
    ))
    assert harness.metric_reader(NAME)(_record(EVENTS)) == pytest.approx(100.0 * 4 / 6)


@pytest.mark.parametrize("kind, want", [("rx.decode_graph_replays", 100.0), ("rx.decode_graph_captures", 0.0),
                                        ("rx.decode_graph_eager", 0.0)])
def test_all_or_none_replayed(monkeypatch, kind, want):
    """A window of replays alone reads 100; of captures or eager groups alone, 0."""
    _canned(monkeypatch, _records(_call(1110, {kind: 1}), _call(1310), _call(1320, {kind: 2})))
    assert harness.metric_reader(NAME)(_record(EVENTS)) == want


def test_none_without_decode_graphs(monkeypatch):
    """The CPU or a program without decode graphs (its decodes count none of
    the three), no group decoded in the window, groups decoded only outside
    it, a tracer that recorded nothing, no tracer."""
    read = harness.metric_reader(NAME)
    _canned(monkeypatch, _records(_call(1110, {}), _call(1310, {"fec.viterbi_kernel_frames": 2})))
    assert read(_record(EVENTS)) is None
    _canned(monkeypatch, _records(_call(1110), _call(1310)))
    assert read(_record(EVENTS)) is None
    _canned(monkeypatch, _records(_call(1700, {"rx.decode_graph_replays": 1})))
    assert read(_record(EVENTS)) is None
    _canned(monkeypatch, [])
    assert read(_record(EVENTS)) is None
    monkeypatch.delattr(profiling, "calls")
    assert read(_record(EVENTS)) is None
