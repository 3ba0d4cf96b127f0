"""The staging of ``StreamReceiver.process``'s block scan (``phy/stream.py``:
``_ScanSlot``), on the CPU.

Every receiver of one layout in a process stages its blocks into one buffer
per shape bucket; on a card that buffer feeds a CUDA graph of the scan
(``tests/test_torch_cuda_scan_graph.py`` holds the graph to the eager scan).
Here: a buffer that held a longer block gives a shorter one the record and
frames of a fresh buffer, the CPU scan captures and replays nothing, slots are
shared by layout alone, and receivers in threads get their own frames."""

import dataclasses
import sys
import threading

import numpy as np
import pytest

from cognitive_radio_network_tpu_torch.phy import stream
from cognitive_radio_network_tpu_torch.phy.framegen import OFDMFrameConfig, OFDMFrameGen
from cognitive_radio_network_tpu_torch.phy.framesync import _bucket_len
from cognitive_radio_network_tpu_torch.phy.stream import StreamReceiver
from cognitive_radio_network_tpu_torch.utils import profiling


def _tape(frames=2, payload_len=16, gap=400, lead=300, seed=3, cfg=None):
    """Frames of one configuration in light noise: (samples, payloads)."""
    rng = np.random.default_rng(seed)
    gen = OFDMFrameGen(cfg or OFDMFrameConfig(), payload_len)
    headers = rng.integers(0, 256, (frames, 8)).astype(np.uint8)
    payloads = rng.integers(0, 256, (frames, payload_len)).astype(np.uint8)
    iq = gen.assemble(headers, payloads, device="cpu").numpy()
    n = lead + frames * (gen.frame_len + gap)
    x = (1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    for k in range(frames):
        pos = lead + k * (gen.frame_len + gap)
        x[pos : pos + gen.frame_len] += iq[k]
    return x, payloads


def _fields(frames):
    return [(f["offset"], bytes(f["header"]), bytes(f["payload"]), dataclasses.astuple(f["stats"]))
            for f in frames]


def _receive(x, block, cfg=None):
    rx = StreamReceiver(cfg or OFDMFrameConfig(), device="cpu")
    return [f for i in range(0, len(x), block) for f in rx.process(x[i : i + block])]


@pytest.fixture
def fresh_slots():
    """No slot left by an earlier test, and none left to a later one."""
    stream._scan_cache.clear()
    yield stream._scan_cache.slots
    stream._scan_cache.clear()


def test_a_reused_buffer_zeroes_the_longer_blocks_tail(fresh_slots, monkeypatch):
    """A loud 2,040-sample block, then a 1,850-sample block with a frame in
    the same bucket from another receiver: the record and frames equal those
    of a fresh buffer, and nothing past the block's samples is left."""
    y, payloads = _tape(frames=1, gap=700)
    y = y[:1850]
    assert _bucket_len(2040, 128) == _bucket_len(len(y), 128) == 2048
    rng = np.random.default_rng(11)
    loud = (rng.standard_normal(2040) + 1j * rng.standard_normal(2040)).astype(np.complex64)
    records = []

    def recorded(*args, **kwargs):
        records.append(stream_scan(*args, **kwargs).clone())
        return records[-1]

    stream_scan = stream._scan_block_graph_packed
    monkeypatch.setattr(stream, "_scan_block_graph_packed", recorded)
    StreamReceiver(OFDMFrameConfig(), device="cpu").process(loud)
    reused = StreamReceiver(OFDMFrameConfig(), device="cpu").process(y)
    (slot,) = fresh_slots.values()
    assert not slot.host[:, len(y):].any()
    fresh_slots.clear()
    fresh = StreamReceiver(OFDMFrameConfig(), device="cpu").process(y)
    assert len(records) == 3 and records[1].equal(records[2])
    assert _fields(reused) == _fields(fresh)
    assert [bytes(f["payload"]) for f in fresh] == [bytes(payloads[0])]


def test_the_cpu_scan_captures_and_replays_nothing(fresh_slots):
    x, _ = _tape(frames=2)
    with profiling.recording() as recs:
        frames = _receive(x, 900)
    calls = [c for c in profiling.calls(recs) if c["name"] == "rx.process"]
    scanned = [c for c in calls if "rx.scan" in c["seconds"]]
    assert len(frames) == 2 and len(scanned) >= 4
    assert sum(c["counts"].get("rx.scan_graph_replays", 0) for c in calls) == 0
    assert sum(c["counts"].get("rx.scan_graph_captures", 0) for c in calls) == 0
    assert all(slot.n_valid is None and not slot.graphs for slot in fresh_slots.values())


def test_slots_are_shared_by_layout_and_bucket(fresh_slots):
    """Receivers of one geometry share a slot per bucket, whatever their
    candidate count; another geometry has its own."""
    x, _ = _tape(frames=1, gap=700)
    a = StreamReceiver(OFDMFrameConfig(), device="cpu")
    b = StreamReceiver(OFDMFrameConfig(), max_frames_per_block=4, device="cpu")
    wide = OFDMFrameConfig(num_subcarriers=64)
    c = StreamReceiver(wide, device="cpu")
    assert a.layout is b.layout is not c.layout
    for rx in (a, b, c):
        rx.process(x[:1800])
    assert sorted((key[1] is c.layout, key[2]) for key in fresh_slots) == [(False, 2048), (True, 2048)]


def test_receivers_in_threads_get_their_own_frames(fresh_slots):
    """Six receivers of one geometry in six threads, switching every
    microsecond, deliver the frames each delivers alone."""
    tapes = [_tape(frames=2, gap=300 + 97 * s, seed=20 + s)[0] for s in range(6)]
    alone = [_fields(_receive(x, 700)) for x in tapes]
    assert all(len(f) == 2 for f in alone)
    got = [None] * len(tapes)

    def run(s):
        got[s] = _fields(_receive(tapes[s], 700))

    threads = [threading.Thread(target=run, args=(s,)) for s in range(len(tapes))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert got == alone
