"""The port's tracer (``utils/profiling.py``: ``span``, ``count``, ``recording``)
and the spans and counters placed in the sense call, the stream receiver and
the Viterbi loop.  All on the CPU; the tracer's records are host times, so
nothing here depends on a card."""

import collections
import contextlib
import dataclasses
import json

import numpy as np
import pytest
import torch

from cognitive_radio_network_tpu_torch.models.sense import SenseConfig, make_sense_fn
from cognitive_radio_network_tpu_torch.phy import fec
from cognitive_radio_network_tpu_torch.phy.framegen import OFDMFrameConfig, OFDMFrameGen
from cognitive_radio_network_tpu_torch.phy.stream import StreamReceiver
from cognitive_radio_network_tpu_torch.signal.mlp import init_mlp
from cognitive_radio_network_tpu_torch.utils import profiling

RX_STAGES = ["rx.stage", "rx.upload", "rx.scan", "rx.scan_read", "rx.resolve", "rx.decode",
             "rx.decode_read"]


def _children(records, parent):
    return [r for r in records if r["parent"] == parent["index"]]


# --- the tracer ---------------------------------------------------------------


def test_off_records_nothing():
    before = (len(profiling.recorded()), profiling.dropped())
    assert profiling.span("a") is profiling.span("b")  # the shared no-op
    with profiling.span("a"):
        profiling.count("c", 3)
    profiling.count("d")
    assert (len(profiling.recorded()), profiling.dropped()) == before
    with pytest.raises(KeyError):  # the no-op lets an exception through
        with profiling.span("a"):
            raise KeyError("a")


def test_recording_nests_and_counts():
    with profiling.recording() as recs:
        with profiling.span("top"):
            profiling.count("top.n", 2)
            with profiling.span("mid"):
                with profiling.span("leaf"):
                    profiling.count("leaf.n")
                    profiling.count("leaf.n", 4)
                profiling.count("mid.n", 5)
            with profiling.span("mid2"):
                pass
        with profiling.span("second"):
            pass
        profiling.count("loose", 7)
    assert recs and [r["name"] for r in recs] == ["top", "mid", "leaf", "mid2", "second", "loose"]
    top, mid, leaf, mid2, second, loose = recs
    assert top["parent"] is None and mid["parent"] == top["index"] and leaf["parent"] == mid["index"]
    assert mid2["parent"] == top["index"] and second["parent"] is None
    assert {r["call"] for r in (top, mid, leaf, mid2)} == {top["index"]}
    assert second["call"] == second["index"] != top["call"]
    assert top["counts"] == {"top.n": 2} and mid["counts"] == {"mid.n": 5}
    assert leaf["counts"] == {"leaf.n": 5} and mid2["counts"] == {} == second["counts"]
    assert loose["parent"] is None and loose["t0"] == loose["t1"] and loose["counts"] == {"loose": 7}
    assert top["t0"] <= mid["t0"] <= leaf["t0"] <= leaf["t1"] <= mid["t1"] <= mid2["t0"] <= top["t1"]
    assert top["t1"] <= second["t0"]
    # outside the block the tracer is off again
    assert profiling.span("x") is profiling.span("y")
    by_call = {c["name"]: c for c in profiling.calls(recs)}
    assert by_call["top"]["counts"] == {"top.n": 2, "mid.n": 5, "leaf.n": 5}
    assert by_call["top"]["seconds"]["top"] == pytest.approx(top["t1"] - top["t0"])
    assert set(by_call) == {"top", "second", "loose"}


def test_an_exception_closes_its_spans():
    with profiling.recording() as recs:
        with pytest.raises(KeyError):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    raise KeyError("x")
        with profiling.span("after"):
            pass
    outer, inner, after = recs
    assert inner["parent"] == outer["index"] and after["parent"] is None  # the stack unwound
    assert all(r["t1"] >= r["t0"] for r in recs)


def test_ring_keeps_its_bound_and_counts_what_it_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "_ring", collections.deque(maxlen=4))
    monkeypatch.setattr(profiling, "_dropped", 0)
    with profiling.recording() as recs:
        for i in range(10):
            with profiling.span(f"s{i}"):
                pass
    assert [r["name"] for r in recs] == ["s6", "s7", "s8", "s9"]
    assert profiling.dropped() == 6 and len(profiling.recorded()) == 4


def test_spans_are_trace_ranges_under_the_profiler(tmp_path):
    with profiling.trace(tmp_path) as _prof:
        with profiling.span("outer"):
            torch.ones(8).sum()
            with profiling.span("inner"):
                torch.ones(8).mul(2)
            profiling.count("outer.n", 2)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ann = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert {"outer", "inner"} <= set(ann)
    o, i = ann["outer"], ann["inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    spans = json.loads((tmp_path / "program_spans.json").read_text())
    assert [r["name"] for r in spans["records"]] == ["outer", "inner"]
    assert spans["records"][0]["counts"] == {"outer.n": 2} and isinstance(spans["dropped"], int)
    assert profiling.span("x") is profiling.span("y")  # off once the profiler stops


@pytest.mark.parametrize("outer", [True, False])
def test_uncounted_keeps_counts_out_of_every_span(outer):
    """Counts made inside ``uncounted`` reach no span, with a span open
    around it or none; a span opened inside records as ever, and counts
    resume after the block."""
    with profiling.recording() as recs:
        with profiling.span("top") if outer else contextlib.nullcontext():
            profiling.count("n")
            with profiling.uncounted():
                profiling.count("n", 10)
                with profiling.span("inner"):
                    pass
                profiling.count("n", 100)
            profiling.count("n", 2)
    inner = next(r for r in recs if r["name"] == "inner")
    assert inner["counts"] == {} and inner["t1"] >= inner["t0"]
    total = sum(c["counts"].get("n", 0) for c in profiling.calls(recs))
    assert total == 3
    if outer:
        top = next(r for r in recs if r["name"] == "top")
        assert top["counts"] == {"n": 3} and inner["parent"] == top["index"]
        assert inner["call"] == top["index"]
    else:
        assert [r["counts"] for r in recs if r["name"] == "n"] == [{"n": 1}, {"n": 2}]


def test_uncounted_off_is_harmless():
    """With nothing recording the block runs and leaves the tracer as it was."""
    before = (len(profiling.recorded()), profiling.dropped())
    with profiling.uncounted():
        profiling.count("n")
    assert (len(profiling.recorded()), profiling.dropped()) == before
    with profiling.recording() as recs:
        profiling.count("after")
    assert [r["counts"] for r in recs] == [{"after": 1}]


# --- the spans placed in the program --------------------------------------------


def _tape(fec0="h128", payload_len=32, frames=3, seed=5):
    """Clean frames of one configuration in light noise, a few hundred samples apart."""
    rng = np.random.default_rng(seed)
    cfg = OFDMFrameConfig(fec0=fec0)
    gen = OFDMFrameGen(cfg, payload_len)
    headers = rng.integers(0, 256, (frames, 8)).astype(np.uint8)
    payloads = rng.integers(0, 256, (frames, payload_len)).astype(np.uint8)
    iq = gen.assemble(headers, payloads, device="cpu").numpy()
    gap = 300
    n = frames * (gen.frame_len + gap) + 2000
    x = 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    for k in range(frames):
        pos = 500 + k * (gen.frame_len + gap)
        x[pos : pos + gen.frame_len] += iq[k]
    return x, payloads


def _receive(x, block=1024):
    rx = StreamReceiver(OFDMFrameConfig(), device="cpu")
    return [f for i in range(0, len(x), block) for f in rx.process(x[i : i + block])]


def _frame_fields(frames):
    return [(f["offset"], bytes(f["header"]), bytes(f["payload"]), dataclasses.astuple(f["stats"]))
            for f in frames]


@pytest.mark.parametrize("fec0", ["h128", "v27"])
def test_stream_receiver_spans_and_counters(fec0):
    x, payloads = _tape(fec0)
    plain = _receive(x)
    with profiling.recording() as recs:
        traced = _receive(x)
    assert _frame_fields(traced) == _frame_fields(plain)  # bit-identical, tracing on or off
    assert [bytes(f["payload"]) for f in traced] == [bytes(p) for p in payloads]
    tops = [r for r in recs if r["name"] == "rx.process"]
    assert tops and all(r["parent"] is None for r in tops)
    attempted = accepted = steps = 0
    for top in tops:
        kids = _children(recs, top)
        names = [r["name"] for r in kids]
        assert names in (RX_STAGES, ["rx.stage"])  # a buffer too short to scan stops after staging
        assert all(top["t0"] <= r["t0"] <= r["t1"] <= top["t1"] for r in kids)
        assert all(a["t1"] <= b["t0"] for a, b in zip(kids, kids[1:]))  # in order, apart
        assert all(r["call"] == top["index"] for r in recs if r["call"] == top["call"])
        for r in kids:
            attempted += r["counts"].get("rx.candidates_attempted", 0)
            accepted += r["counts"].get("rx.candidates_accepted", 0)
            steps += r["counts"].get("fec.viterbi_host_steps", 0)
            if r["counts"]:
                assert r["name"] in ("rx.resolve", "rx.decode")
    assert accepted == len(traced) and attempted >= accepted
    calls = [c for c in profiling.calls(recs) if c["name"] == "rx.process"]
    assert sum(c["counts"].get("rx.candidates_accepted", 0) for c in calls) == len(traced)
    if fec0 == "v27":
        assert steps > 0
    else:
        assert steps == 0


@pytest.mark.parametrize("fec0", ["h128", "v27"])
def test_cpu_process_decodes_eagerly_and_counts_no_decode_graph(fec0):
    """On the CPU every group decodes eagerly: ``process`` delivers the frames
    sent, as the plain run does, and counts none of the card's decode-graph
    counters (``rx.decode_graph_captures``, ``_replays``, ``_eager``)."""
    x, payloads = _tape(fec0)
    plain = _receive(x)
    with profiling.recording() as recs:
        traced = _receive(x)
    assert _frame_fields(traced) == _frame_fields(plain)
    assert [bytes(f["payload"]) for f in traced] == [bytes(p) for p in payloads]
    assert all(f["stats"].payload_valid for f in traced)
    counts = collections.Counter()
    for c in profiling.calls(recs):
        counts.update(c["counts"])
    assert counts["rx.candidates_accepted"] == len(payloads)
    assert not [k for k in counts if k.startswith("rx.decode_graph")]


@pytest.mark.parametrize("with_trace", [False, True])
def test_sense_call_spans(with_trace):
    cfg = SenseConfig()
    rng = np.random.default_rng(3)
    planes = tuple(rng.standard_normal((2 * cfg.averaging, cfg.fft_length)).astype(np.float32)
                   for _ in range(2))
    params = init_mlp(torch.Generator().manual_seed(0))
    fn = make_sense_fn(cfg, with_trace=with_trace, device="cpu")
    args = (planes, params, 433e6) if with_trace else (planes, params)
    plain = fn(*args)
    with profiling.recording() as recs:
        traced = fn(*args)
    res_plain, res_traced = (plain[0], traced[0]) if with_trace else (plain, traced)
    for k in res_plain:
        assert torch.equal(res_plain[k], res_traced[k]), k
    if with_trace:
        assert torch.equal(plain[1], traced[1])
    (top,) = [r for r in recs if r["parent"] is None]
    assert top["name"] == "sense.call"
    kids = _children(recs, top)
    assert [r["name"] for r in kids] == ["sense.place", "sense.prepare", "sense.classify"]
    uploads = _children(recs, kids[0])
    assert [r["name"] for r in uploads] == ["sense.upload", "sense.upload"]  # one per plane
    assert len(recs) == 6 and all(r["call"] == top["index"] for r in recs)
    assert all(top["t0"] <= r["t0"] <= r["t1"] <= top["t1"] for r in recs)


@pytest.mark.parametrize("n_bits", [8, 40])
def test_viterbi_counts_its_host_steps(n_bits):
    rng = np.random.default_rng(n_bits)
    coded = torch.from_numpy(rng.integers(0, 2, (3, 2 * (n_bits + 6))).astype(np.uint8))
    plain = fec.viterbi_decode(coded, n_bits)
    with profiling.recording() as recs:
        with profiling.span("decode"):
            traced = fec.viterbi_decode(coded, n_bits)
            fec.viterbi_decode(coded[:1], n_bits)
    assert torch.equal(plain, traced)
    assert recs[0]["counts"] == {"fec.viterbi_host_steps": 2 * 2 * (n_bits + 6)}
