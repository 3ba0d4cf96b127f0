"""``StreamBank``: one device step over a block of every one of B streams.

On the CPU (``device="cpu"``: the extract and resolve kernels' plain versions).
The bank is held to B separate ``StreamReceiver``s fed the same blocks by
``feed_device``: the same frames (offsets, header and payload bytes, CRC
flags, scheme names), the same ``pending_frame`` and stream offsets, soft
values bit-equal at B = 1 (a receiver's device API is a bank of one) and at
B > 1 within the JAX-parity tolerances of ``test_torch_stream_receiver.py``
(RSSI 1e-3 dB, CFO 1e-6 rad/sample, EVM 0.05 dB above -60 dB): a batch's
sums may add in another order.  One stream of a bank is held to the JAX
package's ``feed_device``, and a bank on the benchmark's link tapes to the
plain reference's soft values.  A step gathers twice, resolves once and
decodes each speculated configuration once, whatever B is, and records the
spans ``rx.step`` and ``rx.step_fetch`` with their counters.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cognitive_radio_network_tpu.phy import OFDMFrameConfig as JConfig
from cognitive_radio_network_tpu.phy import framesync as jfs
from cognitive_radio_network_tpu_torch.ops.resolve import resolve_candidates, resolve_candidates_plain
from cognitive_radio_network_tpu_torch.phy import OFDMFrameConfig, StreamBank, StreamReceiver, framesync, stream
from cognitive_radio_network_tpu_torch.phy.framegen import OFDMFrameGen
from cognitive_radio_network_tpu_torch.utils import profiling

EVM_FLOOR_DB = -60.0
CFG_A = OFDMFrameConfig()
CFG_B = OFDMFrameConfig(mod_scheme="qam16", fec0="none")


def _stream(rng, n, lead, configs=((CFG_A, 48), (CFG_B, 40)), noise=0.003):
    """``n`` samples of frames whose configs cycle through ``configs``, the
    first starting at ``lead`` (negative: the stream starts inside it), gaps
    of 60-900 samples; no frame at all with ``configs`` empty."""
    x = (noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    pos, i = lead, 0
    while configs:
        cfg, plen = configs[i % len(configs)]
        gen = OFDMFrameGen(cfg, plen)
        if pos + gen.frame_len >= n:
            return x
        iq = gen.assemble(rng.integers(0, 256, (1, 8)).astype(np.uint8),
                          rng.integers(0, 256, (1, plen)).astype(np.uint8), device="cpu")[0].numpy()
        lo = max(pos, 0)
        x[lo : pos + len(iq)] += iq[lo - pos :]
        pos += len(iq) + int(rng.integers(60, 900))
        i += 1
    return x


def _streams(rng, b, n):
    """Stream 0 starts inside a frame and changes config every frame (the
    fallback decode), stream 1 has one config, stream 2 carries no frame, the
    rest alternate from a lead of their own."""
    kinds = [(-700, ((CFG_A, 48), (CFG_B, 40))), (150, ((CFG_A, 64),)), (0, ())]
    return [_stream(rng, n, *kinds[j]) if j < len(kinds) else _stream(rng, n, int(rng.integers(0, 2000)))
            for j in range(b)]


def _blocks(data, sizes):
    """(B, n) planes of each block, in turn."""
    s = 0
    for size in sizes:
        seg = np.stack([x[s : s + size] for x in data])
        s += size
        yield torch.from_numpy(seg.real.copy()), torch.from_numpy(seg.imag.copy())


def _frames_equal(got, want, exact):
    assert [f["offset"] for f in got] == [f["offset"] for f in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["header"], w["header"])
        np.testing.assert_array_equal(g["payload"], w["payload"])
        gs, ws = g["stats"], w["stats"]
        for f in ("num_framesyms", "mod_scheme", "mod_bps", "check", "fec0", "fec1",
                  "header_valid", "payload_valid"):
            assert getattr(gs, f) == getattr(ws, f), f
        if exact:
            assert (gs.evm, gs.rssi, gs.cfo) == (ws.evm, ws.rssi, ws.cfo)
            continue
        assert abs(gs.rssi - ws.rssi) <= 1e-3 and abs(gs.cfo - ws.cfo) <= 1e-6
        if max(gs.evm, ws.evm) > EVM_FLOOR_DB:
            assert abs(gs.evm - ws.evm) <= 0.05, (gs.evm, ws.evm)


def _bank_and_receivers(data, sizes, lags, max_frames=8):
    """The same blocks through a bank and through one receiver a stream."""
    b = len(data)
    bank = StreamBank(CFG_A, b, max_frames, device="cpu")
    rxs = [StreamReceiver(CFG_A, max_frames, device="cpu") for _ in range(b)]
    got, want = [[] for _ in range(b)], [[] for _ in range(b)]
    for (br, bi), lag in zip(_blocks(data, sizes), lags):
        for j, frames in enumerate(bank.feed(br, bi, max_lag=lag)):
            got[j] += frames
        for j, rx in enumerate(rxs):
            want[j] += rx.feed_device(br[j], bi[j], max_lag=lag)
    for j, frames in enumerate(bank.flush()):
        got[j] += frames
    for j, rx in enumerate(rxs):
        want[j] += rx.flush()
    assert bank.pending_frame == [rx.pending_frame for rx in rxs]
    assert [rx._residual_offset for rx in bank.receivers] == [rx._residual_offset for rx in rxs]
    return got, want, bank


@pytest.mark.parametrize("b,seed", [(1, 0), (1, 1), (3, 2), (3, 3)])
def test_bank_equals_separate_receivers(b, seed):
    """Streams that start inside a frame, change config (each new config
    falls back to the stream's host decode), or carry nothing; blocks of
    random sizes with two tiny ones among them, random lags."""
    rng = np.random.default_rng(seed)
    n = 16000
    data = _streams(rng, b, n) if b > 1 else [_stream(rng, n, -300)]
    sizes = [int(rng.integers(900, 2600)) for _ in range(3)] + [100, 120]
    while sum(sizes) < n - 2600:
        sizes.append(int(rng.integers(900, 2600)))
    lags = [int(rng.integers(0, 4)) for _ in sizes]
    got, want, bank = _bank_and_receivers(data, sizes, lags)
    for j in range(b):
        _frames_equal(got[j], want[j], exact=b == 1)
    assert len(got[0]) >= 5 and all(f["stats"].payload_valid for frames in got for f in frames)
    assert {f["stats"].mod_scheme for f in got[0]} == {"qam4", "qam16"}
    if b == 3:
        assert len(got[1]) >= 5 and got[2] == []
    assert len(bank._spec_lru) <= 2


def test_bank_stream_matches_jax_feed_device():
    """Stream 1 of a bank of two against the JAX package's ``feed_device`` on
    the same arrays."""
    rng = np.random.default_rng(11)
    data = _streams(rng, 2, 12000)
    bank = StreamBank(CFG_A, 2, 8, device="cpu")
    jrx = jfs.StreamReceiver(JConfig(), max_frames_per_block=8)
    got, want = [], []
    for br, bi in _blocks(data, [1500] * 8):
        got += bank.feed(br, bi, max_lag=2)[1]
        want += jrx.feed_device(jnp.asarray(br[1].numpy()), jnp.asarray(bi[1].numpy()), max_lag=2)
    got += bank.flush()[1]
    want += jrx.flush()
    assert len(got) >= 3
    want = [{**f, "header": np.asarray(f["header"]), "payload": np.asarray(f["payload"])} for f in want]
    _frames_equal(got, want, exact=False)


def test_bank_against_the_plain_reference():
    """Three streams of the benchmark's qam4 h128 link (``crn_bench``'s tapes)
    in four blocks: every whole frame delivered once, at its true start, with
    its bytes, and soft values within the benchmark's limits of the float64
    reference."""
    from crn_bench.reference.link import make_tape
    from crn_bench.reference.phy import soft_values

    link = {"phy": {"num_subcarriers": 32, "cp_len": 16, "taper_len": 4, "mod": "qam4", "fec0": "h128",
                    "fec1": "none", "crc": "crc32"},
            "rx_rate": 1e6, "throughput_bps": 1e6, "tx_gain": 20.0, "tx_gain_soft": -12.0}
    medium = {"sample_rate": 13e6, "noise_power": 1e-6}
    rng = np.random.default_rng(7)
    tapes = [make_tape(link, medium, 20000, rng) for _ in range(3)]
    block = 5042
    data = [t.samples for t in tapes]
    bank = StreamBank(CFG_A, 3, 16, device="cpu")
    got = [[] for _ in tapes]
    for br, bi in _blocks(data, [block] * 4):
        for j, frames in enumerate(bank.feed(br, bi, max_lag=1)):
            got[j] += frames
    for j, frames in enumerate(bank.flush()):
        got[j] += frames
    for tape, frames in zip(tapes, got):
        starts = {int(s): j for j, s in enumerate(tape.starts)}
        flen = tape.layout.frame_len
        whole = sorted(s for s in starts if s + flen <= 4 * block)
        assert [f["offset"] for f in frames] == whole and len(whole) >= 3
        js = [starts[f["offset"]] for f in frames]
        ref = soft_values(tape.layout, np.stack([tape.frame(j) for j in js]))
        for f, j, (cfo, rssi, evm) in zip(frames, js, ref):
            np.testing.assert_array_equal(f["header"], tape.headers[j])
            np.testing.assert_array_equal(f["payload"], tape.payloads[j])
            assert f["stats"].payload_valid
            assert abs(f["stats"].cfo - cfo) < 3e-8 and abs(f["stats"].rssi - rssi) < 1e-3
            assert abs(f["stats"].evm - evm) < 1.0


@pytest.mark.parametrize("seed", [0, 1])
def test_resolve_plain_over_streams_is_each_stream_walked_alone(seed):
    """The walk of B streams' (B, K) tables, by the plain version and by the
    wrapper on CPU tensors, equals B single walks."""
    rng = np.random.default_rng(seed)
    n, prefix = 6000, 300
    for b, k in ((1, 1), (3, 17), (5, 40), (4, 0)):
        offs = np.sort(rng.integers(0, n + 100, (b, k)), axis=1)
        cols = (torch.from_numpy(offs), torch.from_numpy(rng.uniform(0, 1, (b, k)).astype(np.float32)),
                torch.from_numpy(rng.uniform(0, 1, (b, k)) < 0.8),
                torch.from_numpy(rng.integers(prefix, 1500, (b, k))),
                torch.from_numpy(rng.integers(0, n, b)))
        accept, meta = resolve_candidates_plain(*cols, 0.2, n, prefix)
        assert accept.shape == (b, k) and meta.shape == (b, 3)
        for j in range(b):
            one = resolve_candidates_plain(*(c[j] for c in cols[:4]), cols[4][j : j + 1], 0.2, n, prefix)
            assert torch.equal(accept[j], one[0]) and torch.equal(meta[j], one[1])
        again = resolve_candidates(*cols, 0.2, n, prefix)
        assert torch.equal(again[0], accept) and torch.equal(again[1], meta)


@pytest.mark.parametrize("b", [1, 3])
def test_bank_step_launches_do_not_grow_with_streams(b, monkeypatch):
    """Per step: the refinement gather, the header and frame windows' gather,
    one walk of every stream, one decode per speculated configuration."""
    rng = np.random.default_rng(5)
    data = _streams(rng, b, 9000)
    bank = StreamBank(CFG_A, b, 8, device="cpu")
    bank._spec_lru = [(48, "qam4", "h128", "none", "crc32"), (40, "qam16", "none", "none", "crc32")]
    calls = []
    one, sets, walk, rx = framesync.extract_windows, stream.extract_window_sets, stream.resolve_candidates, stream._rx_graph
    monkeypatch.setattr(framesync, "extract_windows", lambda *a, **kw: calls.append("refine") or one(*a, **kw))
    monkeypatch.setattr(stream, "extract_window_sets", lambda *a, **kw: calls.append("sets") or sets(*a, **kw))
    monkeypatch.setattr(stream, "resolve_candidates", lambda *a, **kw: calls.append("walk") or walk(*a, **kw))
    monkeypatch.setattr(stream, "_rx_graph", lambda *a, **kw: calls.append("decode") or rx(*a, **kw))
    steps = 0
    for br, bi in _blocks(data, [1800] * 4):
        bank.feed(br, bi, max_lag=10)
        steps += 1
    assert calls == ["refine", "sets", "walk", "decode", "decode"] * steps


def test_bank_and_feed_device_record_step_spans_and_counters():
    """A step is the span ``rx.step`` (counting streams and candidates), its
    read the span ``rx.step_fetch`` (counting the accepted candidates and
    those no speculated configuration matched, whose fallback decode's
    ``rx.decode`` opens inside it); ``feed_device`` records the same at B = 1."""
    rng = np.random.default_rng(9)
    data = _streams(rng, 2, 9000)
    bank = StreamBank(CFG_A, 2, 8, device="cpu")
    delivered = 0
    with profiling.recording() as recs:
        for br, bi in _blocks(data, [1800] * 5):
            delivered += sum(map(len, bank.feed(br, bi, max_lag=1)))
        delivered += sum(map(len, bank.flush()))
    calls = profiling.calls(recs)
    steps = [c for c in calls if c["name"] == "rx.step"]
    fetches = [c for c in calls if c["name"] == "rx.step_fetch"]
    assert len(steps) == len(fetches) == 5
    assert all(c["counts"] == {"rx.step_streams": 2, "rx.step_candidates": 16} for c in steps)
    accepted = sum(c["counts"].get("rx.step_accepted", 0) for c in fetches)
    misses = sum(c["counts"].get("rx.step_spec_misses", 0) for c in fetches)
    assert accepted == delivered >= 4 and misses >= 2  # each new config falls back
    assert all("rx.decode" in c["seconds"] for c in fetches if c["counts"].get("rx.step_spec_misses"))
    rx = StreamReceiver(CFG_A, 8, device="cpu")
    with profiling.recording() as recs:
        for br, bi in _blocks(data, [1800] * 5):
            rx.feed_device(br[1], bi[1], max_lag=0)
    calls = profiling.calls(recs)
    assert [c["counts"] for c in calls if c["name"] == "rx.step"] == [
        {"rx.step_streams": 1, "rx.step_candidates": 8}] * 5
    assert len([c for c in calls if c["name"] == "rx.step_fetch"]) == 5


def test_bank_refuses_planes_it_cannot_take():
    bank = StreamBank(CFG_A, 2, device="cpu")
    with pytest.raises(ValueError, match=r"a bank of 2 streams takes \(2, n\) planes"):
        bank.feed(torch.zeros(3, 4000), torch.zeros(3, 4000))
    elsewhere = torch.zeros(2, 4000, device="meta")
    with pytest.raises(ValueError, match="receiver on cpu was given planes on meta"):
        bank.feed(elsewhere, elsewhere)
    with pytest.raises(RuntimeError, match="feed the bank"):
        bank.receivers[0].feed_device(torch.zeros(4000), torch.zeros(4000))
    with pytest.raises(RuntimeError, match="feed the bank"):
        bank.receivers[1].flush()
    with pytest.raises(ValueError, match="at least one stream"):
        StreamBank(CFG_A, 0, device="cpu")
    assert bank.feed(np.zeros((2, 4000), np.float32), torch.zeros(2, 4000), max_lag=0) == [[], []]
    assert bank.pending_frame == [False, False]
