"""``StreamReceiver.process``'s group decode replayed from CUDA graphs, on the card.

On a card each group of accepted frames of one payload configuration is
decoded from the scan slot's planes by a CUDA graph captured once per (slot,
payload config, group size G) over static offset and CFO inputs
(``phy/stream.py``: ``_ScanSlot.decode``) and replayed on every later group of
that key.  It runs the eager decode's kernels on the same inputs, so its
packed record must equal the eager ``_rx_at_graph_packed``'s byte for byte:
for both benchmark links' payloads (``predictive_model``'s qam16/crc32/v27+v27
256 bytes, ``eight_node``'s qam4/crc32/h128 64 bytes) at G = 1 and 2, and on
replays whose offsets and CFOs change from call to call.  A replay counts the
extract and Viterbi launches and the Viterbi frames an eager decode counts;
``process`` captures once per key and replays after, and delivers the CPU's
frames; the device API's fallback and a key past the slot's cap decode
eagerly and say so.  Needs a card; run on a GPU machine with

    python -m pytest tests/test_torch_cuda_decode_graph.py -m cuda --noconftest -q
"""

import collections

import numpy as np
import pytest
import torch

from cognitive_radio_network_tpu_torch.ops.extract import extract_windows
from cognitive_radio_network_tpu_torch.ops.viterbi import viterbi_decode_k7
from cognitive_radio_network_tpu_torch.phy import stream
from cognitive_radio_network_tpu_torch.phy.framegen import OFDMFrameConfig, OFDMFrameGen, gen_for
from cognitive_radio_network_tpu_torch.phy.framesync import _bucket_len
from cognitive_radio_network_tpu_torch.phy.stream import StreamReceiver, _rx_at_graph_packed
from cognitive_radio_network_tpu_torch.signal.iq import split_iq
from cognitive_radio_network_tpu_torch.utils import profiling

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card"),
]

GEOMETRY = OFDMFrameConfig()  # both benchmark links' receivers: m=32, cp 16, taper 4
LINKS = {
    "eight_node": (OFDMFrameConfig(mod_scheme="qam4", fec0="h128", fec1="none"), 64),
    "predictive_model": (OFDMFrameConfig(mod_scheme="qam16", fec0="v27", fec1="v27"), 256),
}
GAP = 411


def _key(link) -> tuple:
    cfg, plen = LINKS[link]
    return (plen, cfg.mod_scheme, cfg.fec0, cfg.fec1, cfg.crc_scheme)


def _frames(link, count, seed):
    """``count`` frames of ``link``: (gen, their samples (count, frame_len), payloads)."""
    cfg, plen = LINKS[link]
    rng = np.random.default_rng(seed)
    gen = OFDMFrameGen(cfg, plen)
    pays = rng.integers(0, 256, (count, plen)).astype(np.uint8)
    iq = gen.assemble(rng.integers(0, 256, (count, 8)).astype(np.uint8), pays, device="cpu").numpy()
    return gen, iq, pays


def _staged(link, count, seed=0):
    """A slot holding ``count`` frames of ``link`` in light noise, uploaded:
    (slot, the frames' generator, their offsets, their payloads)."""
    gen, iq, pays = _frames(link, count, seed)
    offs = 137 + np.arange(count, dtype=np.int64) * (gen.frame_len + GAP)
    n = int(offs[-1]) + gen.frame_len + 300
    rng = np.random.default_rng(seed + 1)
    x = (1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    for k, off in enumerate(offs):
        x[off : off + gen.frame_len] += 0.3 * iq[k]
    slot = stream._scan_cache.slot(torch.device("cuda"), gen_for(GEOMETRY, 1),
                                   _bucket_len(n, 4 * GEOMETRY.num_subcarriers))
    slot.stage(np.zeros((2, 0), np.float32), *split_iq(x))
    slot.upload(n)
    return slot, stream._payload_gen(GEOMETRY, _key(link)), offs, pays


def _eager(gen, slot, offs, cfos):
    """The group decode as ``process`` ran it before graphs: fresh input tensors."""
    return _rx_at_graph_packed(gen, slot.planes[0], slot.planes[1], torch.from_numpy(offs).cuda(),
                               torch.from_numpy(cfos).cuda()).cpu()


def _counts(recs) -> collections.Counter:
    counts = collections.Counter()
    for c in profiling.calls(recs):
        counts.update(c["counts"])
    return counts


def _fields(frames):
    return [(f["offset"], bytes(f["header"]), bytes(f["payload"]), f["stats"].header_valid,
             f["stats"].payload_valid) for f in frames]


@pytest.fixture(autouse=True)
def fresh_slots():
    """No slot or graph left by an earlier test, and none left to a later one."""
    stream._scan_cache.clear()
    yield stream._scan_cache.slots
    stream._scan_cache.clear()


@pytest.mark.parametrize("link", sorted(LINKS))
@pytest.mark.parametrize("g", [1, 2])
def test_replayed_record_equals_the_eager_one(link, g):
    """The first group of a key decodes eagerly and captures; the replays
    after it give the eager decode's record bit for bit, whose frames are
    those sent."""
    slot, gen, offs, pays = _staged(link, g, seed=g)
    cfos = np.full(g, 1e-5, np.float32)
    want = _eager(gen, slot, offs, cfos)
    assert want.dtype == torch.uint8 and want.shape == (g, 28 + gen.payload_len)
    for turn in range(3):
        got = slot.decode(gen, _key(link), offs, cfos).cpu()
        assert torch.equal(got, want), turn
    assert list(slot.decodes) == [(_key(link), g)]
    out = stream._unpack_rx_record(got.numpy(), gen.payload_len)
    assert out["hdr_ok"].all() and out["pay_ok"].all()
    np.testing.assert_array_equal(out["payloads"], pays)
    np.testing.assert_array_equal(out["cfo"], cfos)


@pytest.mark.parametrize("link", sorted(LINKS))
def test_each_replay_reads_its_own_offsets_and_cfos(link):
    """Replays of one graph at one frame, then another, then the first with
    another CFO: each gives the eager record of its own inputs, so the static
    inputs are refreshed every call."""
    slot, gen, offs, pays = _staged(link, 2, seed=7)
    turns = [(offs[:1], -1e-5), (offs[1:], 2e-5), (offs[:1], 5e-6), (offs[1:], 2e-5)]
    got = []
    for off, cfo in turns:
        cfos = np.full(1, cfo, np.float32)
        rec = slot.decode(gen, _key(link), off, cfos).cpu()
        assert torch.equal(rec, _eager(gen, slot, off, cfos)), (int(off[0]), cfo)
        got.append(stream._unpack_rx_record(rec.numpy(), gen.payload_len))
    for out, (off, cfo) in zip(got, turns):
        assert out["pay_ok"][0] and out["cfo"][0] == np.float32(cfo)
        np.testing.assert_array_equal(out["payloads"][0], pays[list(offs).index(off[0])])
    assert len(slot.decodes) == 1


@pytest.mark.parametrize("link", sorted(LINKS))
def test_a_replay_counts_what_an_eager_decode_counts(link):
    """The extract and Viterbi kernels' launch counters and the counter
    ``fec.viterbi_kernel_frames`` move by as much for a replay as for an
    eager decode, and the capture itself adds nothing to them."""
    slot, gen, offs, _pays = _staged(link, 2, seed=3)
    cfos = np.zeros(2, np.float32)

    def counted(fn):
        before = extract_windows.launches, viterbi_decode_k7.launches
        with profiling.recording() as recs:
            with profiling.span("t"):
                fn()
        torch.cuda.synchronize()
        return (extract_windows.launches - before[0], viterbi_decode_k7.launches - before[1],
                _counts(recs).get("fec.viterbi_kernel_frames", 0))

    eager = counted(lambda: _eager(gen, slot, offs, cfos))
    assert eager[0] == 1 and eager[1:] == ((2, 4) if link == "predictive_model" else (0, 0))
    assert counted(lambda: slot.decode(gen, _key(link), offs, cfos)) == eager  # eager, then captured
    for _ in range(2):
        assert counted(lambda: slot.decode(gen, _key(link), offs, cfos)) == eager  # replays


@pytest.mark.parametrize("link, block", [("eight_node", 394), ("predictive_model", 5042)])
def test_process_captures_once_per_key_then_replays(fresh_slots, link, block):
    """Through ``process``: every group (here one a call that delivers) is a
    capture or a replay, one capture per (slot, config, G) the slots hold,
    none eager; the frames equal the CPU's."""
    cfg, plen = LINKS[link]
    gen, iq, _pays = _frames(link, 24, seed=11)
    n = 24 * (gen.frame_len + GAP) + 2 * block
    rng = np.random.default_rng(12)
    x = (1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    for k in range(24):
        pos = 137 + k * (gen.frame_len + GAP)
        x[pos : pos + gen.frame_len] += 0.3 * iq[k]
    card, cpu = StreamReceiver(GEOMETRY), StreamReceiver(GEOMETRY, device="cpu")
    got, want, groups = [], [], 0
    with profiling.recording() as recs:
        for s in range(0, n, block):
            frames = card.process(x[s : s + block])
            got += frames
            groups += bool(frames)
    for s in range(0, n, block):
        want += cpu.process(x[s : s + block])
    assert len(want) == 24
    assert _fields(got) == _fields(want)
    counts = _counts(recs)
    keys = [key for k, slot in fresh_slots.items() if k[0].type == "cuda" for key in slot.decodes]
    assert all(key == _key(link) for key, _g in keys)
    assert counts["rx.decode_graph_captures"] == len(keys) >= 1
    assert counts["rx.decode_graph_eager"] == 0
    assert counts["rx.decode_graph_captures"] + counts["rx.decode_graph_replays"] == groups
    assert counts["rx.decode_graph_replays"] >= 1


def test_the_device_apis_fallback_decodes_eagerly():
    """A config none of the speculated ones match (64-byte payloads against
    the first guess of 256) falls back to the grouped decode on the step's own
    buffer, which no slot owns: eager, counted as such, and the frames equal
    the CPU's."""
    link = "eight_node"
    gen, iq, pays = _frames(link, 4, seed=21)
    n = 4 * (gen.frame_len + GAP) + 4000
    rng = np.random.default_rng(22)
    x = (1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    for k in range(4):
        pos = 137 + k * (gen.frame_len + GAP)
        x[pos : pos + gen.frame_len] += 0.3 * iq[k]
    card, cpu = StreamReceiver(GEOMETRY), StreamReceiver(GEOMETRY, device="cpu")
    with profiling.recording() as recs:
        got = [f for s in range(0, n, 2048) for f in card.process_device(*split_iq(x[s : s + 2048]))]
    want = [f for s in range(0, n, 2048) for f in cpu.process_device(*split_iq(x[s : s + 2048]))]
    assert [bytes(f["payload"]) for f in got] == [bytes(p) for p in pays]
    assert _fields(got) == _fields(want)
    counts = _counts(recs)
    assert counts["rx.decode_graph_eager"] >= 1
    assert counts["rx.decode_graph_captures"] == counts["rx.decode_graph_replays"] == 0


def test_a_key_past_the_cap_decodes_eagerly(monkeypatch):
    """With the slot's graphs at the cap, a group of another (config, G)
    gets no graph: the slot says so, the receiver decodes it eagerly, counts
    it, and delivers what the CPU delivers."""
    monkeypatch.setattr(stream, "_DECODE_GRAPHS", 1)
    slot, gen, offs, _pays = _staged("eight_node", 2, seed=5)
    cfos = np.zeros(2, np.float32)
    assert slot.decode(gen, _key("eight_node"), offs[:1], cfos[:1]) is not None
    assert slot.decode(gen, _key("eight_node"), offs, cfos) is None  # G = 2: past the cap
    assert list(slot.decodes) == [(_key("eight_node"), 1)]

    stream._scan_cache.clear()
    rng = np.random.default_rng(31)
    cfgs = [LINKS["eight_node"], (OFDMFrameConfig(mod_scheme="qam16", fec0="none"), 48)]
    n = 40_000
    x = (1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    pos, sent = 200, 0
    while True:
        cfg, plen = cfgs[sent % 2]
        iq = OFDMFrameGen(cfg, plen).assemble(rng.integers(0, 256, (1, 8)).astype(np.uint8),
                                               rng.integers(0, 256, (1, plen)).astype(np.uint8),
                                               device="cpu")[0].numpy()
        if pos + len(iq) + 100 >= n:
            break
        x[pos : pos + len(iq)] += 0.3 * iq
        pos, sent = pos + len(iq) + 300, sent + 1
    card, cpu = StreamReceiver(GEOMETRY), StreamReceiver(GEOMETRY, device="cpu")
    with profiling.recording() as recs:
        got = [f for s in range(0, n, 2500) for f in card.process(x[s : s + 2500])]
    want = [f for s in range(0, n, 2500) for f in cpu.process(x[s : s + 2500])]
    assert len(want) == sent >= 8
    assert _fields(got) == _fields(want)
    counts = _counts(recs)
    assert counts["rx.decode_graph_eager"] >= 1 and counts["rx.decode_graph_captures"] >= 1
    assert all(len(s.decodes) <= 1 for s in stream._scan_cache.slots.values())
