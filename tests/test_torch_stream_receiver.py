"""Port parity: the adaptive streaming receiver of the port vs the JAX package.

The cases of tests/test_ofdm_link.py that drive ``StreamReceiver`` (straddling
blocks, mixed configs, device-resident streaming, the three-API equivalence),
with the same numpy streams fed to both packages.  Frames are assembled once,
by the JAX ``OFDMFrameGen``.  The port runs on the CPU (``device="cpu"``):
``extract_windows`` and ``resolve_candidates`` take their plain versions there.

Exactly equal, between the port's three APIs and against the JAX receiver:
the number of frames, offsets, headers, payloads, header/payload CRC flags,
each frame's scheme names, and ``pending_frame`` after each block.  Within
tolerance: RSSI 1e-3 dB, CFO 1e-6 rad/sample, EVM 0.05 dB where it is above
-60 dB (below that it is float32 rounding noise and differs between the
libraries by a dB or so; there both sides must just be below -60 dB).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cognitive_radio_network_tpu.phy import OFDMFrameConfig as JConfig
from cognitive_radio_network_tpu.phy import OFDMFrameGen as JGen
from cognitive_radio_network_tpu.phy import framesync as jfs
from cognitive_radio_network_tpu.phy.framegen import gen_for as jgen_for
from cognitive_radio_network_tpu_torch.ops.resolve import (
    resolve_candidates,
    resolve_candidates_plain,
)
from cognitive_radio_network_tpu_torch.phy import OFDMFrameConfig, StreamReceiver, framesync, stream
from cognitive_radio_network_tpu_torch.phy import crc as crc_mod
from cognitive_radio_network_tpu_torch.phy import fec as fec_mod
from cognitive_radio_network_tpu_torch.phy import modem
from cognitive_radio_network_tpu_torch.phy.framegen import gen_for, pack_phy_header

EVM_FLOOR_DB = -60.0


def _rx(max_frames=16):
    return StreamReceiver(OFDMFrameConfig(), max_frames_per_block=max_frames, device="cpu")


def _jrx(max_frames=16):
    return jfs.StreamReceiver(JConfig(), max_frames_per_block=max_frames)


def _planes(seg, lib):
    re, im = seg.real.copy(), seg.imag.copy()
    if lib == "jax":
        return jnp.asarray(re), jnp.asarray(im)
    return torch.from_numpy(re), torch.from_numpy(im)


def _assert_frames_equal(got, want):
    assert [f["offset"] for f in got] == [f["offset"] for f in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["header"], np.asarray(w["header"]))
        np.testing.assert_array_equal(g["payload"], np.asarray(w["payload"]))
        gs, ws = g["stats"], w["stats"]
        for f in ("num_framesyms", "mod_scheme", "mod_bps", "check", "fec0", "fec1",
                  "header_valid", "payload_valid"):
            assert getattr(gs, f) == getattr(ws, f), f
        assert abs(gs.rssi - ws.rssi) <= 1e-3, (gs.rssi, ws.rssi)
        assert abs(gs.cfo - ws.cfo) <= 1e-6, (gs.cfo, ws.cfo)
        if max(gs.evm, ws.evm) > EVM_FLOOR_DB:
            assert abs(gs.evm - ws.evm) <= 0.05, (gs.evm, ws.evm)
        else:
            assert gs.evm < EVM_FLOOR_DB and ws.evm < EVM_FLOOR_DB


def _assert_ground_truth(frames, placed):
    assert len(frames) == len(placed)
    for f, (off, pay) in zip(frames, placed):
        assert abs(f["offset"] - off) <= 2
        np.testing.assert_array_equal(f["payload"], pay)
        assert f["stats"].payload_valid


def _noise(rng, n, scale):
    return scale * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def _place(stream, frames_iq, payloads, pos, gap):
    """Add frames to ``stream`` from ``pos`` on, ``gap`` samples apart; returns
    [(offset, payload)] of those that fit."""
    placed = []
    for iq, pay in zip(frames_iq, payloads):
        if pos + len(iq) + 50 >= len(stream):
            break
        stream[pos : pos + len(iq)] += iq
        placed.append((pos, pay))
        pos += len(iq) + gap
    return placed


def _interleave(a, b):
    return [x for pair in zip(a, b) for x in pair]


def _mixed_stream(rng, n, pay_a, pay_b, gap, pos, cfg_b, noise=0.003):
    """Frames alternating between the default config (``pay_a``-byte payloads)
    and ``cfg_b`` (``pay_b``-byte payloads) in noise."""
    f = 6
    ha, hb = (rng.integers(0, 256, (f, 8)).astype(np.uint8) for _ in range(2))
    pa = rng.integers(0, 256, (f, pay_a)).astype(np.uint8)
    pb = rng.integers(0, 256, (f, pay_b)).astype(np.uint8)
    ia = np.asarray(JGen(JConfig(), pay_a).assemble(ha, pa))
    ib = np.asarray(JGen(JConfig(**cfg_b), pay_b).assemble(hb, pb))
    stream = _noise(rng, n, noise)
    placed = _place(stream, _interleave(ia, ib), _interleave(pa, pb), pos, gap)
    return stream, placed


# --- helpers of the step -----------------------------------------------------


def test_bucket_len_matches_reference():
    for n in [*range(0, 3000, 7), *(2**k + d for k in range(10, 25) for d in (-1, 0, 1))]:
        assert framesync._bucket_len(n) == jfs._bucket_len(n)
        assert framesync._bucket_len(n, 128) == jfs._bucket_len(n, 128)


@pytest.mark.parametrize("mod", modem.SCHEMES)
def test_phy_geometry_matches_generator_sizing(mod):
    """Frame lengths from PHY headers equal ``OFDMFrameGen``'s sizing, and the
    JAX ``_phy_geometry``, for every fec0 x fec1 x crc x payload length."""
    layout = gen_for(OFDMFrameConfig(), 1)
    combos = list(itertools.product(fec_mod.SCHEMES, fec_mod.SCHEMES, crc_mod.SCHEMES,
                                    (1, 40, 256, 1000)))
    phys, want = [], []
    for f0, f1, crc, plen in combos:
        cfg = OFDMFrameConfig(mod_scheme=mod, fec0=f0, fec1=f1, crc_scheme=crc)
        phys.append(pack_phy_header(cfg, plen))
        want.append(gen_for(cfg, plen).frame_len)
    phys = np.stack(phys)
    flen, valid = stream._phy_geometry(layout, torch.from_numpy(phys))
    assert flen.dtype == torch.int64 and valid.dtype == torch.bool
    np.testing.assert_array_equal(flen.numpy(), want)
    assert bool(valid.all())
    jflen, jvalid = jfs._phy_geometry(jgen_for(JConfig(), 1), jnp.asarray(phys))
    np.testing.assert_array_equal(flen.numpy(), np.asarray(jflen))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


def test_phy_geometry_flags_out_of_range_ids():
    layout = gen_for(OFDMFrameConfig(), 1)
    bad = np.array([[4, 0, 99, 0, 0, 0], [4, 0, 0, 9, 9, 9], [4, 0, 0, 0, 0, 7],
                    [4, 0, 2, 3, 0, 3]], np.uint8)
    flen, valid = stream._phy_geometry(layout, torch.from_numpy(bad))
    assert valid.tolist() == [False, False, False, True]
    jflen, jvalid = jfs._phy_geometry(jgen_for(JConfig(), 1), jnp.asarray(bad))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(flen.numpy(), np.asarray(jflen))


def _reference_walk(offs, peaks, ok, flen, keep0, thr, n, prefix):
    """The host loop of ``StreamReceiver._resolve_candidates``, on columns."""
    consumed, keep_from, incomplete, accept = 0, keep0, False, [False] * len(offs)
    for i in range(len(offs)):
        if peaks[i] < thr or offs[i] < consumed:
            continue
        if offs[i] + prefix > n:
            keep_from, incomplete = min(keep_from, offs[i]), True
            break
        if not ok[i]:
            continue
        if offs[i] + flen[i] > n:
            keep_from, incomplete = min(keep_from, offs[i]), True
            break
        accept[i] = True
        consumed = offs[i] + flen[i]
    return accept, [consumed, keep_from, int(incomplete)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_resolve_candidates_plain_is_the_host_walk(seed):
    """Random candidate tables (overlaps, weak peaks, bad headers, overruns of
    the prefix and of the frame, ties in offset): the plain version, which the
    CUDA kernel is held to, equals the receiver's host loop."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        k = int(rng.integers(1, 40))
        n, prefix = 6000, 300
        offs = np.sort(rng.integers(0, n + 100, k))
        if k > 2:
            offs[1] = offs[0]  # the top-K pads with repeated candidates
        peaks = rng.uniform(0, 1, k).astype(np.float32)
        ok = rng.uniform(0, 1, k) < 0.8
        flen = rng.integers(prefix, 1500, k)
        keep0 = int(rng.integers(0, n))
        args = (torch.from_numpy(offs), torch.from_numpy(peaks), torch.from_numpy(ok),
                torch.from_numpy(flen), torch.tensor([keep0]), 0.2, n, prefix)
        accept, meta = resolve_candidates_plain(*args)
        want_accept, want_meta = _reference_walk(offs, peaks, ok, flen, keep0, np.float32(0.2),
                                                 n, prefix)
        assert accept.dtype == torch.bool and meta.dtype == torch.int64
        assert accept.tolist() == want_accept and meta.tolist() == want_meta
        again = resolve_candidates(*args)  # CPU tensors: the wrapper runs the plain version
        assert torch.equal(again[0], accept) and torch.equal(again[1], meta)


def _one_block(rng, n=6000):
    """A block with two default-config frames and one qam16/none frame."""
    cfg_b = {"mod_scheme": "qam16", "fec0": "none"}
    stream_, placed = _mixed_stream(rng, n, 48, 40, 300, 200, cfg_b)
    assert len(placed) >= 3
    return stream_


def test_packed_scan_round_trip_and_matches_jax(rng):
    blk = _one_block(rng)
    rr, ri = _planes(blk, "torch")
    layout = gen_for(OFDMFrameConfig(), 1)
    packed = stream._scan_block_graph_packed(layout, rr, ri, len(blk), k=8)
    assert packed.shape == (8, 18) and packed.dtype == torch.int32
    bests, peaks, cfos, headers, phy, hdr_ok = stream._unpack_scan(packed.numpy())
    raw = framesync._scan_block_graph(layout, rr, ri, len(blk), k=8)
    for got, want in zip((bests, peaks, cfos, headers, phy, hdr_ok), raw):
        np.testing.assert_array_equal(got, want.numpy())  # the floats bit for bit
    jpacked = np.asarray(jfs._scan_packed_jit_for(JConfig(), 8)(*_planes(blk, "jax"),
                                                               jnp.int32(len(blk))))
    jb, jpk, jcf, jh, jphy, jok = jfs._unpack_scan(jpacked)
    np.testing.assert_array_equal(bests, jb)
    np.testing.assert_array_equal(hdr_ok, jok)
    good = hdr_ok
    assert good.sum() >= 3
    np.testing.assert_array_equal(headers[good], jh[good])
    np.testing.assert_array_equal(phy[good], jphy[good])
    np.testing.assert_allclose(peaks, jpk, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(cfos[good], jcf[good], rtol=0, atol=1e-6)


def test_packed_rx_round_trip(rng):
    blk = _one_block(rng)
    rr, ri = _planes(blk, "torch")
    gen = gen_for(OFDMFrameConfig(), 48)
    offs = torch.tensor([200, 200 + 2 * (gen.frame_len + 300) - gen.frame_len])
    cfos = torch.zeros(2)
    bpk, fpk = stream._rx_at_graph_packed(gen, rr, ri, offs, cfos)
    assert bpk.shape == (2, 16 + 48) and bpk.dtype == torch.uint8 and fpk.shape == (2, 3)
    out = stream._unpack_rx(bpk.numpy(), fpk.numpy(), 48)
    raw = framesync._rx_at_graph(gen, rr, ri, offs, cfos)
    for key in ("headers", "phy", "payloads", "hdr_ok", "pay_ok", "evm_db", "rssi_db", "cfo"):
        np.testing.assert_array_equal(out[key], raw[key].numpy())
    assert out["hdr_ok"][0] and out["pay_ok"][0]


@pytest.mark.parametrize("specs", [1, 2])
def test_stream_step_record_matches_jax(rng, specs):
    """One step on the same residual and block: the packed record's integers
    (offsets, accept, match, PHY headers, the meta row, decode bytes of
    accepted rows) equal the JAX step's; the float columns are close."""
    blk = _one_block(rng)
    keys = [(48, "qam4", "h128", "none", "crc32"), (40, "qam16", "none", "none", "crc32")][:specs]
    rx, jrx = _rx(8), _jrx(8)
    r_cap = framesync._bucket_len(rx.max_residual)
    assert r_cap == jfs._bucket_len(jrx.max_residual)
    res = _noise(rng, r_cap, 0.003)
    res[: r_cap - 700] = 0  # a residual of 700 live samples, right-aligned
    gens = tuple(rx._sync_for(*k).gen for k in sorted(keys))
    out = stream._stream_step_graph(
        rx.layout, gens, rx.max_residual, *_planes(res, "torch"), torch.tensor(700),
        *_planes(blk, "torch"), 0.2, k=8)
    jout = jfs._stream_step_jit_for(JConfig(), tuple(sorted(keys)), 8, jrx.max_residual)(
        *_planes(res, "jax"), jnp.int32(700), *_planes(blk, "jax"), jnp.float32(0.2))
    packed, jpacked = out[5].numpy(), np.asarray(jout[5])
    assert packed.shape == jpacked.shape and packed.dtype == np.int32
    assert int(out[2]) == int(jout[2])  # new residual length
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jout[0]))  # a copy: exact
    w = 10 + 2 * specs
    np.testing.assert_array_equal(packed[-1], jpacked[-1])  # meta row
    np.testing.assert_array_equal(packed[:-1, [0, 2, 3]], jpacked[:-1, [0, 2, 3]])
    accept = packed[:-1, 2].astype(bool)
    assert accept.sum() >= 3
    np.testing.assert_array_equal(packed[:-1][accept, 4:10], jpacked[:-1][accept, 4:10])
    matched = accept & (packed[:-1, 3] >= 0)
    assert matched.sum() >= (3 if specs == 2 else 2)
    np.testing.assert_array_equal(packed[:-1][matched, w:], jpacked[:-1][matched, w:])
    cfo, jcfo = (np.ascontiguousarray(p[:-1, 1]).view(np.float32) for p in (packed, jpacked))
    np.testing.assert_allclose(cfo[accept], jcfo[accept], rtol=0, atol=1e-6)


def test_count_of_valid_samples_is_exact_past_2_24():
    """The reference's host path uploads the count in a float32 slot
    (``host[0] = n`` of its packed [n | rr | ri] buffer), exact only below
    2**24 samples.  The port carries it as an integer."""
    n = 2**24 + 1
    host = np.zeros(3, np.float32)
    host[0] = n  # the reference's upload
    assert int(host[0]) == 2**24  # one sample lost
    nv = framesync._n_valid(n, torch.device("cpu"))
    assert nv.dtype == torch.int64 and int(nv) == n
    assert int(framesync._n_valid(torch.tensor(n, dtype=torch.int32), torch.device("cpu"))) == n


# --- the host API ------------------------------------------------------------


def _stream_with_frames(rng, iq, gaps=(50, 400)):
    parts, offs, pos = [], [], 0
    for fr in iq:
        g = int(rng.integers(*gaps))
        parts.append(_noise(rng, g, 0.01))
        pos += g
        offs.append(pos)
        parts.append(fr)
        pos += len(fr)
    parts.append(np.zeros(600, np.complex64))
    return np.concatenate(parts), offs


def test_stream_receiver_straddling_blocks(rng):
    b = 6
    headers = rng.integers(0, 256, (b, 8)).astype(np.uint8)
    payloads = rng.integers(0, 256, (b, 64)).astype(np.uint8)
    data, offs = _stream_with_frames(rng, np.asarray(JGen(JConfig(), 64).assemble(headers, payloads)))
    rx, jrx = _rx(), _jrx()
    got, want = [], []
    for s in range(0, len(data), 777):  # deliberately much smaller than frame_len
        got += rx.process(data[s : s + 777])
        want += jrx.process(data[s : s + 777])
        assert rx.pending_frame == jrx.pending_frame
    _assert_ground_truth(got, list(zip(offs, payloads)))
    _assert_frames_equal(got, want)
    np.testing.assert_array_equal([f["header"] for f in got], headers)


def test_stream_receiver_mixed_configs_v27(rng):
    """Per-frame (len, mod, fec) from the PHY header: two payload configs, one
    of them Viterbi-decoded, interleaved in one stream."""
    cfg_b = {"mod_scheme": "qam16", "fec0": "v27", "fec1": "none"}
    pay_a = rng.integers(0, 256, (2, 40)).astype(np.uint8)
    pay_b = rng.integers(0, 256, (2, 96)).astype(np.uint8)
    hdr = rng.integers(0, 256, (4, 8)).astype(np.uint8)
    iq_a = np.asarray(JGen(JConfig(), 40).assemble(hdr[:2], pay_a))
    iq_b = np.asarray(JGen(JConfig(**cfg_b), 96).assemble(hdr[2:], pay_b))
    gap = np.zeros(300, np.complex64)
    data = np.concatenate([gap, iq_a[0], gap, iq_b[0], gap, iq_a[1], gap, iq_b[1], gap])
    rx, jrx = _rx(), _jrx()
    got, want = [], []
    for s in range(0, len(data), 1500):
        got += rx.process(data[s : s + 1500])
        want += jrx.process(data[s : s + 1500])
        assert rx.pending_frame == jrx.pending_frame
    assert len(got) == 4
    assert [f["stats"].fec0 for f in got] == ["h128", "v27", "h128", "v27"]
    np.testing.assert_array_equal([f["payload"] for f in got[0::2]], pay_a)
    np.testing.assert_array_equal([f["payload"] for f in got[1::2]], pay_b)
    assert all(f["stats"].payload_valid for f in got)
    _assert_frames_equal(got, want)


@pytest.mark.parametrize("form", ["complex", "planes", "pair", "tensor-pair", "complex-tensor"])
def test_process_takes_each_iq_form(rng, form):
    data = _one_block(rng)
    planes = np.stack([data.real, data.imag], axis=-1)
    block = {
        "complex": data,
        "planes": planes,
        "pair": (data.real.copy(), data.imag.copy()),
        "tensor-pair": _planes(data, "torch"),
        "complex-tensor": torch.from_numpy(data),
    }[form]
    got = _rx(8).process(block)
    want = _rx(8).process(data)
    assert len(got) >= 3
    _assert_frames_equal(got, want)


def test_skip_and_carry_match_jax(rng):
    """``skip`` drops the residual and moves the cursor; ``carry`` keeps a
    prefix + eighth-block tail, so a frame that starts at the end of a carried
    block still decodes, at the same absolute offset in both packages."""
    h = rng.integers(0, 256, (2, 8)).astype(np.uint8)
    p = rng.integers(0, 256, (2, 48)).astype(np.uint8)
    iq = np.asarray(JGen(JConfig(), 48).assemble(h, p))
    flen = iq.shape[1]
    data = _noise(rng, 12000, 0.003)
    data[3900 : 3900 + flen] += iq[0]  # starts 100 samples before the carried block ends
    data[9000 : 9000 + flen] += iq[1]
    rx, jrx = _rx(8), _jrx(8)
    got, want = [], []
    for r, frames in ((rx, got), (jrx, want)):
        frames += r.process(data[:2000])
        r.carry(data[2000:4000])
        frames += r.process(data[4000:6000])
        r.skip(2000)  # 6000..8000 squelched
        assert len(r._residual) == 0 and not r.pending_frame
        frames += r.process(data[8000:])
    assert rx._residual_offset == jrx._residual_offset
    assert len(rx._residual) == len(jrx._residual)
    _assert_ground_truth(got, [(3900, p[0]), (9000, p[1])])
    _assert_frames_equal(got, want)


def test_tiny_block_early_out(rng):
    """A buffer too short to scan is kept whole, on each API, and leaves
    ``pending_frame`` as it was; the stream decodes as if it had come in one
    piece."""
    data = _one_block(rng)
    whole = _rx(8).process(data)
    cuts = [0, 100, 250, 3000, 3100, len(data)]  # 100- and 150-sample blocks
    host, dev = _rx(8), _rx(8)
    got_h, got_d = [], []
    for a, b in zip(cuts, cuts[1:]):
        seg = data[a:b]
        got_h += host.process(seg)
        got_d += dev.process_device(*_planes(seg, "torch"))
        if b <= 250:
            assert got_h == [] and got_d == []
            assert len(host._residual) == b and not host.pending_frame
            assert int(dev._res_len_d) == b and not dev.pending_frame
    assert len(whole) >= 3
    _assert_frames_equal(got_h, whole)
    _assert_frames_equal(got_d, whole)


def test_default_device_is_the_card():
    rx = StreamReceiver(OFDMFrameConfig())
    assert rx.device.type == "cuda" and rx.fetch_group == 8 and not rx.pending_frame
    assert rx.max_frames_per_block == 16 and rx.prefix_len == 64 + 48 * (1 + rx.layout.n_header_syms)
    assert rx.max_residual == 4 * (rx.prefix_len + 64 * 48)
    if not torch.cuda.is_available():
        block = np.zeros(4000, np.complex64)
        with pytest.raises((RuntimeError, AssertionError)):
            rx.process(block)
        with pytest.raises((RuntimeError, AssertionError)):
            rx.feed_device(block.real.copy(), block.imag.copy())


def test_device_api_refuses_planes_on_another_device():
    """The device API moves host planes to the receiver's device and refuses
    planes that lie on another one: the residual and the fallback decode's
    synchronizers are that device's."""
    rx = StreamReceiver(OFDMFrameConfig(), device="cpu")
    elsewhere = torch.zeros(4000, device="meta")
    with pytest.raises(ValueError, match="receiver on cpu was given planes on meta"):
        rx.feed_device(elsewhere, elsewhere)
    with pytest.raises(ValueError, match="planes on meta"):
        rx.process_device(torch.zeros(4000), elsewhere)
    assert rx.feed_device(np.zeros(4000, np.float32), torch.zeros(4000), max_lag=0) == []


# --- the device API ----------------------------------------------------------


def _drive(data, blocks, lags=None, max_frames=16, jax_device=True):
    """The same blocks through the port's three APIs and the JAX receiver's
    host and device APIs; ``pending_frame`` compared after every block."""
    rx_h, rx_d, rx_p = _rx(max_frames), _rx(max_frames), _rx(max_frames)
    jrx_h, jrx_d = _jrx(max_frames), _jrx(max_frames)
    out = {k: [] for k in ("host", "dev", "pipe", "jax-host", "jax-dev")}
    s = 0
    for i, blk in enumerate(blocks):
        seg = data[s : s + blk]
        s += blk
        out["host"] += rx_h.process(seg)
        out["dev"] += rx_d.process_device(*_planes(seg, "torch"))
        out["pipe"] += rx_p.feed_device(*_planes(seg, "torch"), max_lag=lags[i] if lags else 3)
        out["jax-host"] += jrx_h.process(seg)
        assert rx_h.pending_frame == jrx_h.pending_frame == rx_d.pending_frame
        if jax_device:
            out["jax-dev"] += jrx_d.process_device(*_planes(seg, "jax"))
            assert rx_d.pending_frame == jrx_d.pending_frame
    out["pipe"] += rx_p.flush()
    assert rx_p.pending_frame == rx_d.pending_frame
    assert rx_p._residual_offset == rx_d._residual_offset
    if not jax_device:
        del out["jax-dev"]
    return out


def _assert_all_equal(out, placed):
    _assert_ground_truth(out["host"], placed)
    for key in out:
        _assert_frames_equal(out[key], out["host"])


def test_device_api_matches_host_process_across_blocks(rng):
    data, placed = _mixed_stream(rng, 14000, 48, 40, 997, 50,
                                 {"mod_scheme": "qam16", "fec0": "none"})
    out = _drive(data, [1536] * 10, max_frames=8)  # blocks of 1536: straddlers galore
    assert [f["stats"].mod_scheme for f in out["dev"]] == ["qam4", "qam16"] * (len(placed) // 2)
    _assert_all_equal(out, placed)


def test_pipelined_feed_matches_sync(rng):
    f = 5
    h = rng.integers(0, 256, (f, 8)).astype(np.uint8)
    p = rng.integers(0, 256, (f, 48)).astype(np.uint8)
    data = _noise(rng, 12000, 0.003)
    placed = _place(data, np.asarray(JGen(JConfig(), 48).assemble(h, p)), p, 60, 613)
    out = _drive(data, [1536] * 8, max_frames=8)
    _assert_all_equal(out, placed)
    np.testing.assert_array_equal([f_["header"] for f_ in out["pipe"]], h[: len(placed)])


def _random_stream(rng, n, mods, fecs, pay, gap, pos):
    data = _noise(rng, n, 0.004)
    placed = []
    while True:
        cfg = JConfig(mod_scheme=mods[rng.integers(0, len(mods))],
                      fec0=fecs[rng.integers(0, len(fecs))])
        gen = JGen(cfg, int(rng.integers(*pay)))
        if pos + gen.frame_len + 50 >= n:
            return data, placed
        h = rng.integers(0, 256, (1, 8)).astype(np.uint8)
        p = rng.integers(0, 256, (1, gen.payload_len)).astype(np.uint8)
        iq = np.asarray(gen.assemble(h, p))[0]
        data[pos : pos + len(iq)] += iq
        placed.append((pos, p[0]))
        pos += len(iq) + int(rng.integers(*gap))


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_random_streams_three_apis_bitmatch(seed):
    """Random mixed-config streams with a random block size and random lags:
    ``process``, ``process_device`` and ``feed_device``/``flush`` give the same
    frames, equal to the JAX receiver's and to what was sent."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8000, 20000))
    data, placed = _random_stream(rng, n, ["qam4", "qam16", "bpsk"], ["h128", "none", "rep3"],
                                  (8, 120), (300, 1200), int(rng.integers(0, 400)))
    blk = int(rng.integers(900, 4000))
    blocks = [blk] * -(-n // blk)
    lags = [int(rng.integers(0, 5)) for _ in blocks]
    _assert_all_equal(_drive(data, blocks, lags, jax_device=False), placed)


def test_variable_block_sizes_pipeline():
    """A DIFFERENT block size every call: each closes the open fetch group, and
    the residual chained on the device must still carry exactly."""
    rng = np.random.default_rng(103)
    n = 16000
    data, placed = _random_stream(rng, n, ["qam4", "qam16"], ["h128"], (16, 100), (400, 900), 200)
    blocks, lags, s = [], [], 0
    while s < n:
        blocks.append(int(rng.integers(700, 3500)))
        lags.append(int(rng.integers(0, 4)))
        s += blocks[-1]
    _assert_all_equal(_drive(data, blocks, lags, jax_device=False), placed)


def test_config_change_takes_the_fallback_decode(rng, monkeypatch):
    """Frames whose config is none of the speculated ones (the stream starts
    with payloads that are not the default 256 bytes, then changes scheme) are
    decoded by the grouped host path on the step's buffer, and the history
    follows: later frames of those configs match a spec."""
    cfg_b = {"mod_scheme": "qam16", "fec0": "none"}
    data, placed = _mixed_stream(rng, 14000, 48, 40, 700, 100, cfg_b)
    rx = _rx(8)
    calls, matched = [], []
    real_groups, real_fetch = rx._decode_groups, rx._fetch_step
    monkeypatch.setattr(rx, "_decode_groups",
                        lambda *a: calls.append(sorted(a[2])) or real_groups(*a))

    def fetch(entry, packed):
        rec = packed[:-1]
        matched.extend(rec[rec[:, 2] == 1, 3].tolist())
        return real_fetch(entry, packed)

    monkeypatch.setattr(rx, "_fetch_step", fetch)
    assert rx._spec_lru == [(256, "qam4", "h128", "none", "crc32")]
    got = []
    for s in range(0, len(data), 2048):
        got += rx.process_device(*_planes(data[s : s + 2048], "torch"))
    _assert_ground_truth(got, placed)
    key_a, key_b = (48, "qam4", "h128", "none", "crc32"), (40, "qam16", "none", "none", "crc32")
    assert calls[0] == [key_a] and [key_b] in calls  # each config fell back when first seen
    assert sorted(rx._spec_lru) == sorted([key_a, key_b])
    assert matched[:2] == [-1, -1] and set(matched[2:]) == {0, 1}
    assert len(calls) == 2  # and only then
    _assert_frames_equal(got, _rx(8).process(data))
