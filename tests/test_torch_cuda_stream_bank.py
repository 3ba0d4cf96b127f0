"""``StreamBank`` on the card: one step over a block of every one of B streams.

A bank on the card gives the frames the same bank gives on the CPU (the
kernels' plain versions): offsets, bytes, flags and configs equal, soft values
within the JAX-parity tolerances (float32 sums on the card add in another
order).  A step launches the same extract, resolve and Viterbi kernels at
B = 48 as at B = 1 (two gathers, one walk of every stream, two Viterbi
launches for the one v27 + v27 configuration speculated), and waits for
nothing (PyTorch's sync debug mode raises on a wait).  Kernel 5 over B walks
equals its plain version, and a bank runs beside ``process`` receivers in
other threads.  Needs a card; on a GPU machine:

    python -m pytest tests/test_torch_cuda_stream_bank.py -m cuda --noconftest -q
"""

import threading

import numpy as np
import pytest
import torch

from cognitive_radio_network_tpu_torch.ops.extract import extract_windows
from cognitive_radio_network_tpu_torch.ops.resolve import resolve_candidates, resolve_candidates_plain
from cognitive_radio_network_tpu_torch.ops.viterbi import viterbi_decode_k7
from cognitive_radio_network_tpu_torch.phy import OFDMFrameConfig, OFDMFrameGen, StreamBank, StreamReceiver

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card"),
]

GEOMETRY = OFDMFrameConfig()
V27 = OFDMFrameConfig(mod_scheme="qam16", fec0="v27", fec1="v27")
QAM16_NONE = OFDMFrameConfig(mod_scheme="qam16", fec0="none")


def _stream(rng, n, lead, configs):
    x = (1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    pos, i = lead, 0
    while configs:
        cfg, plen = configs[i % len(configs)]
        gen = OFDMFrameGen(cfg, plen)
        if pos + gen.frame_len >= n:
            break
        iq = gen.assemble(rng.integers(0, 256, (1, 8)).astype(np.uint8),
                          rng.integers(0, 256, (1, plen)).astype(np.uint8), device="cpu")[0].numpy()
        lo = max(pos, 0)
        x[lo : pos + len(iq)] += 0.3 * iq[lo - pos :]
        pos += len(iq) + int(rng.integers(60, 700))
        i += 1
    return x


def _planes(data, s, size, device):
    seg = np.stack([x[s : s + size] for x in data])
    return (torch.from_numpy(seg.real.copy()).to(device), torch.from_numpy(seg.imag.copy()).to(device))


def _run(data, sizes, device, lag=2):
    bank = StreamBank(GEOMETRY, len(data), 8, device=device)
    got, s = [[] for _ in data], 0
    for size in sizes:
        for j, frames in enumerate(bank.feed(*_planes(data, s, size, device), max_lag=lag)):
            got[j] += frames
        s += size
    for j, frames in enumerate(bank.flush()):
        got[j] += frames
    return got, bank


def _assert_close(got, want):
    assert [f["offset"] for f in got] == [f["offset"] for f in want]
    for g, w in zip(got, want):
        assert (g["header"] == w["header"]).all() and (g["payload"] == w["payload"]).all()
        gs, ws = g["stats"], w["stats"]
        assert (gs.mod_scheme, gs.fec0, gs.fec1, gs.header_valid, gs.payload_valid) == (
            ws.mod_scheme, ws.fec0, ws.fec1, ws.header_valid, ws.payload_valid)
        assert abs(gs.rssi - ws.rssi) <= 1e-3 and abs(gs.cfo - ws.cfo) <= 1e-6
        if max(gs.evm, ws.evm) > -60.0:
            assert abs(gs.evm - ws.evm) <= 0.05


def test_bank_on_card_equals_bank_on_cpu():
    rng = np.random.default_rng(3)
    n = 24000
    data = [_stream(rng, n, -500, ((GEOMETRY, 48), (QAM16_NONE, 40))),
            _stream(rng, n, 200, ((GEOMETRY, 64),)),
            _stream(rng, n, 0, ()),
            _stream(rng, n, 900, ((QAM16_NONE, 40), (GEOMETRY, 48)))]
    sizes = [1900, 100, 2100] + [2048] * 9
    card, bank = _run(data, sizes, "cuda")
    cpu, _ = _run(data, sizes, "cpu")
    assert bank._res_r.device.type == "cuda"
    assert len(card[0]) >= 6 and len(card[3]) >= 6 and card[2] == []
    for got, want in zip(card, cpu):
        _assert_close(got, want)


@pytest.mark.parametrize("b", [1, 48])
def test_bank_step_launches_the_same_kernels_at_any_width(b):
    """One step of the gateway's link (qam16 v27 + v27) speculated alone:
    2 extract launches, 1 resolve launch, 2 Viterbi launches, whatever B, and
    no wait for the card inside the dispatch."""
    rng = np.random.default_rng(b)
    one = _stream(rng, 4 * 5042, 300, ((V27, 256),))
    data = [np.roll(one, 97 * j) for j in range(b)]
    bank = StreamBank(GEOMETRY, b, 16)
    bank._spec_lru = [(256, "qam16", "v27", "v27", "crc32")]
    counts = []
    for step in range(4):
        planes = _planes(data, step * 5042, 5042, "cuda")
        before = (extract_windows.launches, resolve_candidates.launches, viterbi_decode_k7.launches)
        # the first step fills the generators' tables on the card (uploads that wait)
        torch.cuda.set_sync_debug_mode("error" if step else "default")
        try:
            bank.feed(*planes, max_lag=8)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        counts.append((extract_windows.launches - before[0], resolve_candidates.launches - before[1],
                       viterbi_decode_k7.launches - before[2]))
    frames = bank.flush()
    assert counts == [(2, 1, 2)] * 4
    assert all(len(f) >= 2 and all(fr["stats"].payload_valid for fr in f) for f in frames)


@pytest.mark.parametrize("b,k", [(1, 16), (48, 16), (6, 428), (3, 1500)])
def test_resolve_kernel_over_streams_equals_plain(b, k):
    rng = np.random.default_rng(k + b)
    n, prefix = 2_500_000, 304
    offs = np.sort(rng.integers(0, n + 2000, (b, k)), axis=1)
    cols = (offs, rng.uniform(0, 1, (b, k)).astype(np.float32), rng.uniform(0, 1, (b, k)) < 0.9,
            rng.integers(prefix, 6000, (b, k)), rng.integers(0, n, b))
    cols = tuple(torch.from_numpy(c).cuda() for c in cols)
    before = resolve_candidates.launches
    accept, meta = resolve_candidates(*cols, 0.2, n, prefix)
    assert resolve_candidates.launches == before + 1
    want = resolve_candidates_plain(*cols, 0.2, n, prefix)
    assert torch.equal(accept, want[0]) and torch.equal(meta, want[1])
    with pytest.raises(ValueError, match="one keep0 a stream"):
        resolve_candidates(*cols[:4], cols[4][:1].repeat(b + 1), 0.2, n, prefix)


def test_bank_beside_process_receivers_in_threads():
    """A bank fed in one thread while two ``process`` receivers (their scans
    and decodes captured as CUDA graphs on first use) run in another: each
    gives the frames it gives alone."""
    rng = np.random.default_rng(21)
    n = 20000
    data = [_stream(rng, n, int(rng.integers(0, 900)), ((GEOMETRY, 64),)) for _ in range(3)]
    sizes = [2048] * 9
    alone, _ = _run(data, sizes, "cuda")
    host_alone = []
    for x in data[:2]:
        rx = StreamReceiver(GEOMETRY)
        host_alone.append([f for s in range(0, n, 1500) for f in rx.process(x[s : s + 1500])])
    out, errors = {}, []

    def bank_side():
        try:
            out["bank"] = _run(data, sizes, "cuda")[0]
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    def host_side():
        try:
            rxs = [StreamReceiver(GEOMETRY) for _ in range(2)]
            got = [[], []]
            for s in range(0, n, 1500):
                for j, rx in enumerate(rxs):
                    got[j] += rx.process(data[j][s : s + 1500])
            out["host"] = got
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=bank_side), threading.Thread(target=host_side)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for got, want in zip(out["bank"], alone):
        _assert_close(got, want)
    for got, want in zip(out["host"], host_alone):
        _assert_close(got, want)
    assert all(len(f) >= 4 for f in alone)
