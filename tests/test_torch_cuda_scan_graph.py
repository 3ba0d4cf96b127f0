"""``StreamReceiver.process``'s block scan replayed from CUDA graphs, on the card.

On a card the scan of a block is captured once per (layout, bucket, k) as a
CUDA graph over a static (2, bucket) plane buffer and a 0-d ``n_valid``
(``phy/stream.py``: ``_ScanSlot``) and replayed on every later call.  It runs
the eager scan's kernels on the same inputs, so its packed record must equal
the eager ``_scan_block_graph_packed``'s byte for byte: at several buckets of
both benchmark links' receivers (m=32: ``eight_node``'s qam4 h128 frames and
``predictive_model``'s qam16 v27+v27), with two block lengths in one bucket
replayed in turn (a frozen ``n_valid`` would show), for two receivers
interleaved on one cache, and through ``process`` against the CPU's frames,
also while another thread runs a transmit chain on the card as new shapes are
captured.  A replay counts the extract kernel's launches the eager scan counts.
Needs a card; run on a GPU machine with

    python -m pytest tests/test_torch_cuda_scan_graph.py -m cuda --noconftest -q
"""

import threading

import numpy as np
import pytest
import torch

from cognitive_radio_network_tpu_torch.ops.extract import extract_windows
from cognitive_radio_network_tpu_torch.phy import stream
from cognitive_radio_network_tpu_torch.phy.framegen import OFDMFrameConfig, OFDMFrameGen, gen_for
from cognitive_radio_network_tpu_torch.phy.framesync import _bucket_len
from cognitive_radio_network_tpu_torch.phy.stream import StreamReceiver, _scan_block_graph_packed
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


def _tape(link, n, seed=0, gap=411):
    """``n`` samples of back-to-back frames of ``link`` in light noise."""
    cfg, plen = LINKS[link]
    rng = np.random.default_rng(seed)
    gen = OFDMFrameGen(cfg, plen)
    frames = -(-n // (gen.frame_len + gap)) + 1
    iq = gen.assemble(rng.integers(0, 256, (frames, 8)).astype(np.uint8),
                      rng.integers(0, 256, (frames, plen)).astype(np.uint8), device="cpu").numpy()
    x = (1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    for k in range(frames):
        pos = 137 + k * (gen.frame_len + gap)
        end = min(pos + gen.frame_len, n)
        if pos < end:
            x[pos:end] += 0.3 * iq[k, : end - pos]
    return x


def _eager(layout, buf, bucket, k):
    """The scan as ``process`` ran it before graphs: fresh planes, an int n."""
    host = np.zeros((2, bucket), np.float32)
    host[0, : len(buf)], host[1, : len(buf)] = buf.real, buf.imag
    planes = torch.from_numpy(host).cuda()
    return _scan_block_graph_packed(layout, planes[0], planes[1], len(buf), k=k)


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
@pytest.mark.parametrize("lengths", [(600, 520), (1900, 1800), (5730, 5500), (12000, 11000)])
def test_replayed_record_equals_the_eager_one(fresh_slots, link, lengths):
    """Two block lengths of one bucket, each staged, uploaded and scanned in
    turn through one slot (the first call eager and captured, the rest
    replays): every record equals the eager scan's, bit for bit."""
    layout = gen_for(GEOMETRY, 1)
    bucket = _bucket_len(lengths[0], 4 * GEOMETRY.num_subcarriers)
    assert _bucket_len(lengths[1], 4 * GEOMETRY.num_subcarriers) == bucket
    k = 16
    slot = stream._scan_cache.slot(torch.device("cuda"), layout, bucket)
    x = _tape(link, lengths[0] + 4 * 997, seed=sum(lengths))
    for turn, n in enumerate([lengths[0], lengths[1], lengths[0], lengths[1]]):
        buf = x[turn * 997 : turn * 997 + n]
        slot.stage(np.zeros((2, 0), np.float32), *split_iq(buf))  # no residual
        slot.upload(n)
        before = extract_windows.launches
        got = slot.scan(layout, n, k).cpu()
        launched = extract_windows.launches - before
        want = _eager(layout, buf, bucket, k).cpu()
        assert launched == extract_windows.launches - before - launched == 2, turn
        assert got.dtype == want.dtype == torch.int32 and got.shape == want.shape
        assert torch.equal(got, want), (turn, n)
    assert list(slot.graphs) == [k]


def test_one_capture_per_new_key_then_one_replay_a_call(fresh_slots):
    """The counters inside ``rx.scan``: a call whose (bucket, k) is new
    captures once and replays nothing; every later call replays once."""
    x = _tape("eight_node", 60_000, seed=3)
    rx = StreamReceiver(GEOMETRY)
    with profiling.recording() as recs:
        for s in range(0, len(x), 394):
            rx.process(x[s : s + 394])
    calls = [c for c in profiling.calls(recs) if c["name"] == "rx.process" and "rx.scan" in c["seconds"]]
    assert len(calls) > 100
    keys = [(k[2], kk) for k, slot in fresh_slots.items() for kk in slot.graphs]
    captures = replays = 0
    for c in calls:
        got = (c["counts"].get("rx.scan_graph_captures", 0), c["counts"].get("rx.scan_graph_replays", 0))
        assert got in ((1, 0), (0, 1))
        captures, replays = captures + got[0], replays + got[1]
    assert captures == len(keys) == len(set(keys)) >= 3
    assert replays == len(calls) - captures
    assert replays > 0.8 * len(calls)


@pytest.mark.parametrize("block", [394, 5042])
def test_two_receivers_interleaved_on_one_cache_deliver_the_cpus_frames(fresh_slots, block):
    """Two card receivers of one geometry, called in turn, share the slots and
    graphs, and each delivers what a CPU receiver delivers from its stream."""
    tapes = [_tape("eight_node", 40 * block, seed=5), _tape("eight_node", 40 * block, seed=6, gap=700)]
    card = [StreamReceiver(GEOMETRY) for _ in tapes]
    cpu = [StreamReceiver(GEOMETRY, device="cpu") for _ in tapes]
    got = [[], []]
    want = [[], []]
    for s in range(0, 40 * block, block):
        for i, x in enumerate(tapes):
            got[i] += card[i].process(x[s : s + block])
            want[i] += cpu[i].process(x[s : s + block])
    for i in range(2):
        assert len(want[i]) >= 5
        assert _fields(got[i]) == _fields(want[i])
    card_slots = [slot for key, slot in fresh_slots.items() if key[0].type == "cuda"]
    assert card_slots and all(len(slot.graphs) == 1 for slot in card_slots)


def test_mixed_stream_through_process_equals_the_cpu():
    """A stream that changes payload configuration from frame to frame (qam4
    h128, qam16 none, qam16 v27+v27), in blocks of several lengths: the card
    with graphs delivers the CPU's frames."""
    rng = np.random.default_rng(9)
    cfgs = [LINKS["eight_node"], (OFDMFrameConfig(mod_scheme="qam16", fec0="none"), 48),
            (LINKS["predictive_model"][0], 64)]
    n = 60_000
    x = (1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    pos, sent = 200, 0
    while True:
        cfg, plen = cfgs[sent % len(cfgs)]
        iq = OFDMFrameGen(cfg, plen).assemble(rng.integers(0, 256, (1, 8)).astype(np.uint8),
                                               rng.integers(0, 256, (1, plen)).astype(np.uint8),
                                               device="cpu")[0].numpy()
        if pos + len(iq) + 100 >= n:
            break
        x[pos : pos + len(iq)] += 0.3 * iq
        pos, sent = pos + len(iq) + int(rng.integers(50, 900)), sent + 1
    sizes = rng.integers(300, 3000, 200)
    card, cpu = StreamReceiver(GEOMETRY), StreamReceiver(GEOMETRY, device="cpu")
    got, want, s = [], [], 0
    with profiling.recording() as recs:
        for size in sizes:
            if s >= n:
                break
            got += card.process(x[s : s + size])
            want += cpu.process(x[s : s + size])
            s += int(size)
    assert len(want) == sent >= 10
    assert _fields(got) == _fields(want)
    calls = profiling.calls(recs)
    assert sum(c["counts"].get("rx.scan_graph_replays", 0) for c in calls) > 0


def test_captures_while_another_thread_transmits_on_the_card(fresh_slots):
    """A distributed node transmits in a worker thread while it receives: the
    transmit chain allocates, launches and reads back on the card while
    ``process`` captures graphs for new shapes.  Neither thread fails, and the
    card delivers the CPU's frames."""
    from cognitive_radio_network_tpu_torch.runtime.radio import _tx_chain_fn_for

    cfg, plen = LINKS["eight_node"]
    gen = gen_for(cfg, plen)
    chain = _tx_chain_fn_for(cfg, plen, 5, 4, torch.device("cuda"))
    rng = np.random.default_rng(11)
    hdr = gen.encode_header_batch(rng.integers(0, 256, (4, 8)).astype(np.uint8))
    pay = gen.encode_payload_batch(rng.integers(0, 256, (4, plen)).astype(np.uint8))
    want_tx = chain(hdr, pay, np.float32(0.5))
    stop, errors, sent = threading.Event(), [], [0]

    def transmit():
        try:
            while not stop.is_set():
                assert np.array_equal(chain(hdr, pay, np.float32(0.5)), want_tx)
                fresh = torch.ones(1 << (12 + sent[0] % 10), device="cuda")  # a new block now and then
                assert fresh.sum().item() == fresh.numel()
                sent[0] += 1
        except Exception as exc:  # noqa: BLE001 - handed to the test's thread
            errors.append(exc)

    x = _tape("eight_node", 150_000, seed=12)
    sizes = np.random.default_rng(13).integers(300, 12_000, 60)
    card, cpu = StreamReceiver(GEOMETRY), StreamReceiver(GEOMETRY, device="cpu")
    got, want, s = [], [], 0
    worker = threading.Thread(target=transmit)
    worker.start()
    try:
        with profiling.recording() as recs:
            for size in sizes:
                if s >= len(x):
                    break
                got += card.process(x[s : s + size])
                want += cpu.process(x[s : s + size])
                s += int(size)
    finally:
        stop.set()
        worker.join()
    assert not errors, errors
    assert sent[0] > 20
    counts = [c["counts"] for c in profiling.calls(recs) if c["name"] == "rx.process"]
    assert sum(c.get("rx.scan_graph_captures", 0) for c in counts) >= 5
    assert len(want) >= 10
    assert _fields(got) == _fields(want)
