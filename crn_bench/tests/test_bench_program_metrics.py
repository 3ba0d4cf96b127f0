"""The metrics that read the program's own spans and counters
(``utils/profiling.py``), on a canned trace and canned program records,
and on a program without the tracer, where each reads None."""

import collections

import pytest

from crn_bench import harness
from crn_bench.tests.test_bench_metrics import _kernel, _launch, _record, _span
from cognitive_radio_network_tpu_torch.utils import profiling

PROGRAM = ["sense_upload_us.decision", "sense_classify_us.decision", "sense_glue_us.decision",
           "scan_us_per_block.rx", "scan_ops_per_block.rx", "resolve_us_per_block.rx",
           "candidate_yield_pct.rx", "viterbi_host_steps_per_block.rx"]


def _records(*calls):
    """Program records from (name, t0 us, t1 us, counts, children): host seconds, one call each."""
    out, index = [], 0
    for name, t0, t1, counts, children in calls:
        top = index
        out.append({"name": name, "index": top, "parent": None, "call": top, "t0": t0 * 1e-6,
                    "t1": t1 * 1e-6, "counts": counts})
        for cname, c0, c1, ccounts, parent in children:
            index += 1
            out.append({"name": cname, "index": index, "parent": top + parent, "call": top,
                        "t0": c0 * 1e-6, "t1": c1 * 1e-6, "counts": ccounts})
        index += 1
    return out


RX = _records(
    ("rx.process", 1110, 1190, {}, [
        ("rx.stage", 1110, 1112, {}, 0), ("rx.upload", 1112, 1115, {}, 0), ("rx.scan", 1115, 1135, {}, 0),
        ("rx.scan_read", 1135, 1140, {}, 0),
        ("rx.resolve", 1140, 1150, {"rx.candidates_attempted": 3, "rx.candidates_accepted": 1}, 0),
        ("rx.decode", 1150, 1180, {"fec.viterbi_host_steps": 100}, 0)]),
    ("rx.process", 1310, 1390, {}, [
        ("rx.upload", 1310, 1311, {}, 0), ("rx.scan", 1311, 1321, {}, 0), ("rx.scan_read", 1321, 1323, {}, 0),
        ("rx.resolve", 1323, 1329, {"rx.candidates_attempted": 1, "rx.candidates_accepted": 1}, 0),
        ("rx.decode", 1330, 1380, {"fec.viterbi_host_steps": 300}, 0)]),
    # fed after the window's close (no harness span around it): left out
    ("rx.process", 1600, 1700, {}, [
        ("rx.scan", 1600, 1650, {}, 0),
        ("rx.resolve", 1650, 1700, {"rx.candidates_attempted": 5, "rx.candidates_accepted": 0}, 0),
        ("rx.decode", 1690, 1700, {"fec.viterbi_host_steps": 1000}, 0)]),
)
RX_EVENTS = [_span("process", 1100, 100), _span("rx.scan", 1115, 20), _launch(1120, 1), _kernel(1121, 5, 1),
             _launch(1125, 2), _kernel(1130, 5, 2), _span("process", 1300, 100), _span("rx.scan", 1311, 10),
             _launch(1315, 3), _kernel(1316, 5, 3), _span("rx.scan", 1600, 50), _launch(1610, 4),
             _kernel(1611, 5, 4), _launch(1620, 5), _kernel(1621, 5, 5)]

SENSE = _records(
    ("sense.call", 1110, 1290, {}, [
        ("sense.place", 1110, 1200, {}, 0), ("sense.upload", 1120, 1150, {}, 1),
        ("sense.upload", 1150, 1190, {}, 1), ("sense.prepare", 1200, 1210, {}, 0),
        ("sense.classify", 1210, 1280, {}, 0)]),
    ("sense.call", 1500, 1900, {}, [("sense.upload", 1500, 1800, {}, 0)]),  # outside the harness's span
)
SENSE_EVENTS = [_span("sense_call", 1100, 200)]

WANT = {
    "sense_upload_us.decision": 70.0,
    "sense_classify_us.decision": 70.0,
    "sense_glue_us.decision": 180.0 - 70.0 - 70.0,
    "scan_us_per_block.rx": ((3 + 20 + 5) + (1 + 10 + 2)) / 2,
    "scan_ops_per_block.rx": (2 + 1) / 2,
    "resolve_us_per_block.rx": (10 + 6) / 2,
    "candidate_yield_pct.rx": 100.0 * 2 / 4,
    "viterbi_host_steps_per_block.rx": (100 + 300) / 2,
}


def _canned(monkeypatch, records):
    monkeypatch.setattr(profiling, "_ring", collections.deque(records, maxlen=len(records) or 1))


@pytest.mark.parametrize("name", PROGRAM)
def test_reads_the_programs_records(monkeypatch, name):
    sense = name.endswith(".decision")
    _canned(monkeypatch, SENSE if sense else RX)
    rec = _record(SENSE_EVENTS if sense else RX_EVENTS)
    assert harness.metric_reader(name)(rec) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", PROGRAM)
def test_none_without_the_programs_spans(monkeypatch, name):
    events = SENSE_EVENTS if name.endswith(".decision") else [_span("process", 1100, 100)]
    _canned(monkeypatch, [])  # a tracer that recorded nothing
    assert harness.metric_reader(name)(_record(events)) is None
    monkeypatch.delattr(profiling, "calls")  # the parent: no tracer at all
    assert harness.metric_reader(name)(_record(events)) is None


def test_no_yield_where_nothing_was_attempted(monkeypatch):
    _canned(monkeypatch, _records(("rx.process", 1110, 1190, {}, [
        ("rx.resolve", 1140, 1150, {"rx.candidates_attempted": 0, "rx.candidates_accepted": 0}, 0)])))
    read = harness.metric_reader("candidate_yield_pct.rx")
    assert read(_record([_span("process", 1100, 100)])) is None
