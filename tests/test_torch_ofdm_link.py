"""Port parity: the fixed-config OFDM link of the port vs the JAX package.

framegen -> channel -> framesync, the cases of tests/test_ofdm_link.py:18-213
(minus the adaptive StreamReceiver), with the same numpy IQ fed to both
packages.  Exactly equal: offsets, headers, payloads, header/payload CRC
flags.  Within tolerance:

* assembled frames: atol 1e-5 (float32 IFFTs in two libraries);
* RSSI: 1e-3 dB;
* CFO: 1e-6 rad/sample;
* EVM: 0.05 dB where the EVM is above -60 dB (noise-limited).  A clean
  channel's EVM is float32 rounding noise (below -60 dB) and differs between
  libraries by a dB or so; there both sides must just be below -60 dB.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cognitive_radio_network_tpu.phy import OFDMFrameConfig as JConfig
from cognitive_radio_network_tpu.phy import OFDMFrameGen as JGen
from cognitive_radio_network_tpu.phy import OFDMFrameSync as JSync
from cognitive_radio_network_tpu.phy import framesync as jfs
from cognitive_radio_network_tpu.phy.framesync import _scan_jit_for
from cognitive_radio_network_tpu_torch.ops.extract import extract_windows
from cognitive_radio_network_tpu_torch.phy import OFDMFrameConfig, OFDMFrameGen, OFDMFrameSync
from cognitive_radio_network_tpu_torch.phy import framesync as fs
from cognitive_radio_network_tpu_torch.phy.framegen import gen_for
from cognitive_radio_network_tpu_torch.phy.framesync import _scan_block_graph

EVM_FLOOR_DB = -60.0


def _pair(payload_len, **kw):
    """(port gen, port sync, JAX gen, JAX sync) for one config."""
    return (
        OFDMFrameGen(OFDMFrameConfig(**kw), payload_len),
        OFDMFrameSync(OFDMFrameConfig(**kw), payload_len, device="cpu"),
        JGen(JConfig(**kw), payload_len),
        JSync(JConfig(**kw), payload_len),
    )


def _frames(rng, b, payload_len):
    headers = rng.integers(0, 256, (b, 8)).astype(np.uint8)
    payloads = rng.integers(0, 256, (b, payload_len)).astype(np.uint8)
    return headers, payloads


def _assert_stats_close(got, want):
    for f in ("num_framesyms", "mod_scheme", "mod_bps", "check", "fec0", "fec1",
              "header_valid", "payload_valid"):
        assert getattr(got, f) == getattr(want, f), f
    assert abs(got.rssi - want.rssi) <= 1e-3, (got.rssi, want.rssi)
    assert abs(got.cfo - want.cfo) <= 1e-6, (got.cfo, want.cfo)
    if max(got.evm, want.evm) > EVM_FLOOR_DB:
        assert abs(got.evm - want.evm) <= 0.05, (got.evm, want.evm)
    else:
        assert got.evm < EVM_FLOOR_DB and want.evm < EVM_FLOOR_DB


def _assert_demod_equal(got, want):
    (gs, gh, gp), (ws, wh, wp) = got, want
    np.testing.assert_array_equal(gh, np.asarray(wh))
    np.testing.assert_array_equal(gp, np.asarray(wp))
    assert len(gs) == len(ws)
    for g, w in zip(gs, ws):
        _assert_stats_close(g, w)


def _assert_frames_equal(got, want):
    assert [f["offset"] for f in got] == [f["offset"] for f in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["header"], w["header"])
        np.testing.assert_array_equal(g["payload"], w["payload"])
        _assert_stats_close(g["stats"], w["stats"])


def _burst(frames_iq, gaps, lead=100, tail=600):
    """(B, L) complex frames -> one block with the given gaps; returns
    (block, offsets)."""
    parts, offs, pos = [np.zeros(lead, np.complex64)], [], lead
    for i, fr in enumerate(frames_iq):
        offs.append(pos)
        parts.append(fr)
        pos += len(fr)
        g = gaps[i % len(gaps)]
        parts.append(np.zeros(g, np.complex64))
        pos += g
    parts.append(np.zeros(tail, np.complex64))
    return np.concatenate(parts), offs


# --- assembly --------------------------------------------------------------

_ASSEMBLE = {
    "qam4-h128": {},
    "qam16-v27": {"mod_scheme": "qam16", "fec0": "v27"},
    "bpsk-none": {"mod_scheme": "bpsk", "fec0": "none"},
    "v27-v27-notaper": {"mod_scheme": "qam16", "fec0": "v27", "fec1": "v27", "taper_len": 0},
}


@pytest.mark.parametrize("name", sorted(_ASSEMBLE))
def test_assemble_matches_jax(rng, name):
    gen, _, jgen, _ = _pair(40, **_ASSEMBLE[name])
    headers, payloads = _frames(rng, 3, 40)
    planes = gen.assemble(headers, payloads, as_planes=True, device="cpu")
    want = np.asarray(jgen.assemble(headers, payloads, as_planes=True))
    assert planes.shape == want.shape == (3, gen.frame_len, 2)
    assert planes.dtype == torch.float32
    np.testing.assert_allclose(planes.numpy(), want, rtol=0, atol=1e-5)
    iq = gen.assemble(headers, payloads, device="cpu")
    assert iq.dtype == torch.complex64
    np.testing.assert_allclose(iq.numpy(), np.asarray(jgen.assemble(headers, payloads)), atol=1e-5)


# --- aligned demodulation --------------------------------------------------


@pytest.mark.parametrize(
    "mod,fec0,fec1",
    [("qam4", "h128", "none"), ("qam16", "v27", "none"), ("bpsk", "none", "none")],
)
def test_demod_aligned_clean(rng, mod, fec0, fec1):
    gen, sync, jgen, jsync = _pair(64, mod_scheme=mod, fec0=fec0, fec1=fec1)
    headers, payloads = _frames(rng, 4, 64)
    iq = np.asarray(jgen.assemble(headers, payloads))
    got = sync.demod_aligned(iq)
    _assert_demod_equal(got, jsync.demod_aligned(iq))
    np.testing.assert_array_equal(got[2], payloads)
    assert all(s.header_valid and s.payload_valid and s.evm < -20 for s in got[0])


def test_demod_aligned_planes_and_tensor_input(rng):
    gen, sync, jgen, jsync = _pair(32)
    headers, payloads = _frames(rng, 2, 32)
    planes = np.asarray(jgen.assemble(headers, payloads, as_planes=True))
    want = jsync.demod_aligned(planes)
    _assert_demod_equal(sync.demod_aligned(planes), want)
    _assert_demod_equal(sync.demod_aligned(torch.from_numpy(planes)), want)
    _assert_demod_equal(
        sync.demod_aligned((torch.from_numpy(planes[..., 0]), torch.from_numpy(planes[..., 1]))),
        want,
    )


def test_demod_aligned_awgn(rng):
    gen, sync, jgen, jsync = _pair(64)
    headers, payloads = _frames(rng, 4, 64)
    iq = np.asarray(jgen.assemble(headers, payloads))
    p = np.mean(np.abs(iq) ** 2)
    sigma = np.sqrt(p / 10 ** (20.0 / 10) / 2)
    noisy = (iq + sigma * (rng.standard_normal(iq.shape) + 1j * rng.standard_normal(iq.shape))
             ).astype(np.complex64)
    got = sync.demod_aligned(noisy)
    _assert_demod_equal(got, jsync.demod_aligned(noisy))
    np.testing.assert_array_equal(got[2], payloads)
    assert all(-30 < s.evm < -5 and s.payload_valid for s in got[0])


def test_demod_aligned_flat_gain_phase(rng):
    """S1 channel estimation absorbs a flat complex channel."""
    gen, sync, jgen, jsync = _pair(40, mod_scheme="qam16")
    headers, payloads = _frames(rng, 2, 40)
    iq = (np.asarray(jgen.assemble(headers, payloads)) * (0.35 * np.exp(1j * 1.1))).astype(
        np.complex64
    )
    got = sync.demod_aligned(iq)
    _assert_demod_equal(got, jsync.demod_aligned(iq))
    np.testing.assert_array_equal(got[2], payloads)


def test_demod_aligned_with_cfo_argument(rng):
    gen, sync, jgen, jsync = _pair(48)
    headers, payloads = _frames(rng, 3, 48)
    iq = np.asarray(jgen.assemble(headers, payloads))
    cfo = np.asarray([0.001, -0.002, 0.0005], np.float32)
    rot = np.exp(1j * cfo[:, None] * np.arange(iq.shape[1]))
    shifted = (iq * rot).astype(np.complex64)
    got = sync.demod_aligned(shifted, cfo=cfo)
    _assert_demod_equal(got, jsync.demod_aligned(shifted, cfo=jnp.asarray(cfo)))
    np.testing.assert_array_equal(got[2], payloads)


def test_v27_v27_link(rng):
    """The predictive scenario's SU link coding: conv K=7 r=1/2 inner and
    outer (scenarios/predictive_model.cfg:81-82), Viterbi decoded twice."""
    gen, sync, jgen, jsync = _pair(64, mod_scheme="qam16", fec0="v27", fec1="v27")
    headers, payloads = _frames(rng, 3, 64)
    iq = np.asarray(jgen.assemble(headers, payloads))
    got = sync.demod_aligned(iq)
    _assert_demod_equal(got, jsync.demod_aligned(iq))
    np.testing.assert_array_equal(got[2], payloads)


def test_corrupted_payload_flags_match(rng):
    """A frame whose payload region is wiped decodes with payload_valid
    False on both sides, header intact."""
    gen, sync, jgen, jsync = _pair(64)
    headers, payloads = _frames(rng, 2, 64)
    iq = np.asarray(jgen.assemble(headers, payloads)).copy()
    iq[1, -600:] = 0.5 * (rng.standard_normal(600) + 1j * rng.standard_normal(600))
    got = sync.demod_aligned(iq)
    _assert_demod_equal(got, jsync.demod_aligned(iq))
    assert [s.payload_valid for s in got[0]] == [True, False]
    assert all(s.header_valid for s in got[0])


# --- detection and block receive -------------------------------------------


def test_receive_with_cfo_in_noise(rng):
    gen, sync, jgen, jsync = _pair(48)
    headers, payloads = _frames(rng, 1, 48)
    iq = np.asarray(jgen.assemble(headers, payloads))[0]
    offset, cfo = 333, 0.002
    n_total = offset + len(iq) + 500
    block = (0.01 * (rng.standard_normal(n_total) + 1j * rng.standard_normal(n_total))).astype(
        np.complex64
    )
    block[offset : offset + len(iq)] += iq * np.exp(1j * cfo * np.arange(len(iq)))
    got_off, stats, hdr, pay = sync.receive(block)
    want_off, want_stats, want_hdr, want_pay = jsync.receive(jnp.asarray(block))
    assert got_off == want_off and abs(got_off - offset) <= 2
    _assert_stats_close(stats, want_stats)
    assert abs(stats.cfo - cfo) < 5e-4
    np.testing.assert_array_equal(hdr, want_hdr)
    np.testing.assert_array_equal(pay, payloads[0])
    peak, best, det_cfo = sync.detect(block)
    jpeak, jbest, jcfo = jsync.detect(jnp.asarray(block))
    assert int(best) == int(jbest)
    assert abs(float(peak) - float(jpeak)) <= 1e-5 and abs(float(det_cfo) - float(jcfo)) <= 1e-6


def test_receive_returns_none_without_a_fitting_frame(rng):
    gen, sync, jgen, jsync = _pair(48)
    headers, payloads = _frames(rng, 1, 48)
    iq = np.asarray(jgen.assemble(headers, payloads))[0]
    noise = 0.01 * (rng.standard_normal(3000) + 1j * rng.standard_normal(3000))
    noise = noise.astype(np.complex64)
    cut = np.concatenate([noise[:200], iq[: len(iq) // 2]])  # frame overruns the block
    for block in (noise, cut):
        assert sync.receive(block) == (None, None, None, None)
        assert jsync.receive(jnp.asarray(block))[0] is None


@pytest.mark.parametrize("snr_db", [None, 15.0])
def test_receive_block_multi_frame(rng, snr_db):
    """Several frames in one noise-padded block: the same frame list."""
    gen, sync, jgen, jsync = _pair(64)
    headers, payloads = _frames(rng, 6, 64)
    iq = np.asarray(jgen.assemble(headers, payloads))
    block, offs = _burst(iq, gaps=(57, 301, 120))
    if snr_db is not None:
        sigma = np.sqrt(np.mean(np.abs(iq) ** 2) / 10 ** (snr_db / 10) / 2)
        block = (block + sigma * (rng.standard_normal(block.shape)
                                  + 1j * rng.standard_normal(block.shape))).astype(np.complex64)
    got = sync.receive_block(block, k=16)
    _assert_frames_equal(got, jsync.receive_block(block, k=16))
    assert len(got) == 6
    for f, o, h, p in zip(got, offs, headers, payloads):
        assert abs(f["offset"] - o) <= 2
        np.testing.assert_array_equal(f["header"], h)
        np.testing.assert_array_equal(f["payload"], p)


_IQ_FORMS = {
    "complex-numpy": lambda x: x,
    "complex-tensor": torch.from_numpy,
    "planes-tensor": lambda x: torch.view_as_real(torch.from_numpy(x)),
    "planar-views": lambda x: (torch.from_numpy(x).real, torch.from_numpy(x).imag),
}


@pytest.mark.parametrize("form", sorted(_IQ_FORMS))
def test_receive_block_input_forms(rng, form):
    """Every IQ form the entry points document (complex, (N, 2) planes, a
    planar tuple, also as strided views) decodes the same frames as the
    reference."""
    gen, sync, jgen, jsync = _pair(32)
    headers, payloads = _frames(rng, 3, 32)
    block, offs = _burst(np.asarray(jgen.assemble(headers, payloads)), gaps=(90,))
    got = sync.receive_block(_IQ_FORMS[form](block), k=8)
    _assert_frames_equal(got, jsync.receive_block(block, k=8))
    assert [f["offset"] for f in got] == offs
    np.testing.assert_array_equal(np.stack([f["payload"] for f in got]), payloads)


def _reference_fixed_walk(offs, peaks, ok, thr, frame_len):
    """The fixed-config acceptance, as a plain loop over (offset, index) order."""
    kept, consumed = [], 0
    for i in sorted(range(len(offs)), key=lambda i: (offs[i], i)):
        if peaks[i] >= thr and ok[i] and offs[i] >= consumed:
            kept.append(i)
            consumed = offs[i] + frame_len
    return kept


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fixed_walk_is_the_plain_loop(seed):
    """Random candidate tables (overlaps, weak peaks, false ``ok``, equal
    offsets, unsorted): the walk ``receive_block`` and the sharded fixed-config
    receiver share keeps the candidates the plain loop keeps, in its order."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        k = int(rng.integers(1, 40))
        offs = rng.integers(0, 6000, k)
        if k > 2:
            offs[2] = offs[0]  # the top-K pads with repeated candidates
        peaks = rng.uniform(0, 1, k).astype(np.float32)
        ok = rng.uniform(0, 1, k) < 0.8
        frame_len = int(rng.integers(100, 1500))
        got = fs._accept_fixed(offs, peaks, ok, 0.2, frame_len)
        assert got == _reference_fixed_walk(offs, peaks, ok, np.float32(0.2), frame_len)
        starts = offs[got]
        assert (np.diff(starts) >= frame_len).all()  # kept frames never overlap


def test_rx_block_fn_slice(rng):
    """The slice as a whole: a default-config burst of 8 frames with 80-sample
    gaps (the shape of tests/tpu_gates.py::gate_ofdm_decode, cut to F=8 and
    64-byte payloads) through one rx_block_fn(k=8) call on each side.  Rows
    that pass ``ok`` are compared sorted by offset; the filler rows of top-K
    are not part of the contract."""
    gen, sync, jgen, jsync = _pair(64)
    headers, payloads = _frames(rng, 8, 64)
    iq = np.asarray(jgen.assemble(headers, payloads))
    block, offs = _burst(iq, gaps=(80,), lead=0, tail=80)
    rr = np.ascontiguousarray(block.real.astype(np.float32))
    ri = np.ascontiguousarray(block.imag.astype(np.float32))
    n = len(rr)
    before = extract_windows.launches
    rx = sync.rx_block_fn(k=8)
    bests, peaks, cfos, out, ok = rx(torch.from_numpy(rr), torch.from_numpy(ri), n)
    assert extract_windows.launches == before  # CPU tensors: the plain version
    jb, jp, jc, jout, jok = jsync.rx_block_fn(k=8)(jnp.asarray(rr), jnp.asarray(ri), jnp.int32(n))
    ok, jok = ok.numpy(), np.asarray(jok)
    assert ok.sum() == jok.sum() == 8
    sel = np.argsort(bests.numpy(), kind="stable")
    sel = sel[ok[sel]]
    jsel = np.argsort(np.asarray(jb), kind="stable")
    jsel = jsel[jok[jsel]]
    np.testing.assert_array_equal(bests.numpy()[sel], np.asarray(jb)[jsel])
    np.testing.assert_array_equal(bests.numpy()[sel], offs)
    np.testing.assert_allclose(peaks.numpy()[sel], np.asarray(jp)[jsel], rtol=1e-5)
    np.testing.assert_allclose(cfos.numpy()[sel], np.asarray(jc)[jsel], atol=1e-6)
    for key in ("headers", "phy", "payloads", "hdr_ok", "pay_ok"):
        np.testing.assert_array_equal(out[key].numpy()[sel], np.asarray(jout[key])[jsel],
                                      err_msg=key)
    np.testing.assert_allclose(out["rssi_db"].numpy()[sel], np.asarray(jout["rssi_db"])[jsel],
                               atol=1e-3)
    np.testing.assert_array_equal(out["payloads"].numpy()[sel], payloads)
    # decode_at: the same frames from the offsets and CFOs found
    at = sync.decode_at(torch.from_numpy(rr), torch.from_numpy(ri), bests[sel], cfos[sel])
    for key in ("headers", "payloads", "hdr_ok", "pay_ok"):
        assert torch.equal(at[key], out[key][sel]), key
    # n_valid as a 0-d tensor, cut inside the last frame: that frame drops out
    cut = offs[-1] + gen.frame_len - 1
    *_, ok_cut = rx(torch.from_numpy(rr), torch.from_numpy(ri), torch.tensor(cut))
    *_, jok_cut = jsync.rx_block_fn(k=8)(jnp.asarray(rr), jnp.asarray(ri), jnp.int32(cut))
    assert int(ok_cut.sum()) == int(np.asarray(jok_cut).sum()) == 7


def test_scan_block_matches_jax(rng):
    """The header scan (top-K + header demod + header decode for all K)."""
    gen, sync, jgen, jsync = _pair(40)
    headers, payloads = _frames(rng, 3, 40)
    iq = np.asarray(jgen.assemble(headers, payloads))
    block, offs = _burst(iq, gaps=(150,))
    rr = np.ascontiguousarray(block.real.astype(np.float32))
    ri = np.ascontiguousarray(block.imag.astype(np.float32))
    got = _scan_block_graph(gen_for(OFDMFrameConfig(), 1), torch.from_numpy(rr),
                            torch.from_numpy(ri), len(rr), k=4)
    want = _scan_jit_for(JConfig(), 4)(jnp.asarray(rr), jnp.asarray(ri), jnp.int32(len(rr)))
    ok, jok = got[5].numpy(), np.asarray(want[5])
    sel = np.argsort(got[0].numpy(), kind="stable")
    sel = sel[ok[sel]]
    jsel = np.argsort(np.asarray(want[0]), kind="stable")
    jsel = jsel[jok[jsel]]
    np.testing.assert_array_equal(got[0].numpy()[sel], offs)
    np.testing.assert_array_equal(np.asarray(want[0])[jsel], offs)
    for g, w in zip(got[3:5], want[3:5]):
        np.testing.assert_array_equal(g.numpy()[sel], np.asarray(w)[jsel])
    np.testing.assert_array_equal(got[3].numpy()[sel], headers)


# --- the detector's parts, where the port could drift ----------------------


def _block_planes(rng, n_frames=3, noise=0.0):
    gen, sync, jgen, jsync = _pair(40)
    headers, payloads = _frames(rng, n_frames, 40)
    block, offs = _burst(np.asarray(jgen.assemble(headers, payloads)), gaps=(150, 333))
    if noise:
        block = block + noise * (rng.standard_normal(block.shape)
                                 + 1j * rng.standard_normal(block.shape))
    rr = np.ascontiguousarray(block.real.astype(np.float32))
    ri = np.ascontiguousarray(block.imag.astype(np.float32))
    return gen, jgen, rr, ri, offs


@pytest.mark.parametrize("h", [16, 12])
def test_box3h_and_sc_metric_match_jax(rng, h):
    """The sliding sums keep the reference's doubling ladder (h a power of
    two: bit-equal adds) or its cumsum difference (otherwise); the S&C
    metric agrees within float32 rounding, and its masked tail is -1 on
    both sides."""
    x = (rng.standard_normal(5000) + 1j * rng.standard_normal(5000)).astype(np.complex64)
    got = fs._box3h(torch.from_numpy(x), h).numpy()
    want = np.asarray(jfs._box3h(jnp.asarray(x), h))
    if h & (h - 1) == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    _, _, rr, ri, _ = _block_planes(rng, noise=0.01)
    m, n_valid = 2 * h, len(rr) - 500
    metric, p, half = fs._sc_metric(torch.complex(torch.from_numpy(rr), torch.from_numpy(ri)),
                                    torch.tensor(n_valid), m)
    jmetric, jp, jhalf = jfs._sc_metric(jnp.asarray(rr) + 1j * jnp.asarray(ri),
                                        jnp.int32(n_valid), m)
    assert half == jhalf
    jmetric = np.asarray(jmetric)
    np.testing.assert_array_equal(metric.numpy() == -1.0, jmetric == -1.0)
    np.testing.assert_allclose(metric.numpy(), jmetric, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-4, atol=1e-4)
    assert int(torch.argmax(metric)) == int(np.argmax(jmetric))


def test_topk_candidates_match_jax_with_ties(rng):
    """K larger than the number of frames: the filler rows come from windows
    whose values tie at -1, and the stable descending sort picks them in the
    order ``lax.top_k`` does, so every row matches, not only the frames."""
    gen, jgen, rr, ri, offs = _block_planes(rng)
    m, n = gen.cfg.num_subcarriers, len(rr)
    tmpl = gen.device_constants("cpu")["tmpl"]
    r = torch.complex(torch.from_numpy(rr), torch.from_numpy(ri))
    metric, p, half = fs._sc_metric(r, torch.tensor(n), m)
    got = fs._topk_core(torch.from_numpy(rr), torch.from_numpy(ri), metric, p, half, tmpl, m,
                        12, cp=gen.cfg.cp_len)
    jr = jnp.asarray(rr) + 1j * jnp.asarray(ri)
    jmetric, jp, jhalf = jfs._sc_metric(jr, jnp.int32(n), m)
    jtmpl = jnp.asarray(tmpl.numpy())
    want = jfs._topk_core(jnp.asarray(rr), jnp.asarray(ri), jmetric, jp, jhalf, jtmpl,
                          jnp.int32(n), m, 12, cp=gen.cfg.cp_len)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-4, atol=1e-6)
    assert set(offs) <= set(got[0].tolist())


@pytest.mark.parametrize(
    "lead,tail",
    [(300, 40), (300, 120), (300, 700), (984, 40), (976, 48), (968, 56), (4056, 40)],
)
def test_detect_near_block_end_matches_jax(rng, lead, tail):
    """A preamble close to the end of the block, including blocks of a
    power-of-two length (1024, 4096) cut inside the preamble: there the
    refinement window is clipped back into the padded block, so the offset
    found depends on the padding, and the port pads as the reference does.
    The same (peak, offset, cfo) as the reference."""
    gen, sync, jgen, jsync = _pair(40)
    headers, payloads = _frames(rng, 1, 40)
    iq = np.asarray(jgen.assemble(headers, payloads))[0]
    noise = 0.01 * (rng.standard_normal(lead + tail) + 1j * rng.standard_normal(lead + tail))
    block = noise.astype(np.complex64)
    block[lead:] += iq[:tail]
    peak, best, cfo = sync.detect(block)
    jpeak, jbest, jcfo = jsync.detect(jnp.asarray(block))
    assert int(best) == int(jbest)
    assert abs(float(peak) - float(jpeak)) <= 1e-5
    assert abs(float(cfo) - float(jcfo)) <= 1e-6


def test_link_entry_points_default_to_the_card(rng):
    """OFDMFrameSync, assemble and constellation name the card by default and
    raise where there is none; device="cpu" decodes on the CPU as before."""
    import inspect

    from cognitive_radio_network_tpu_torch.phy import modem

    assert inspect.signature(OFDMFrameSync.__init__).parameters["device"].default == "cuda"
    assert inspect.signature(OFDMFrameGen.assemble).parameters["device"].default == "cuda"
    assert inspect.signature(modem.constellation).parameters["device"].default == "cuda"
    cfg = OFDMFrameConfig()
    gen = OFDMFrameGen(cfg, 32)
    assert OFDMFrameSync(cfg, 32).device.type == "cuda"
    headers, payloads = _frames(rng, 2, 32)
    iq = gen.assemble(headers, payloads, device="cpu")
    assert iq.device.type == "cpu"
    stats, hdr, pay = OFDMFrameSync(cfg, 32, device="cpu").demod_aligned(iq.numpy())
    np.testing.assert_array_equal(hdr, headers)
    np.testing.assert_array_equal(pay, payloads)
    assert all(s.payload_valid for s in stats)
    if torch.cuda.is_available():
        return  # the defaults then run; tests/test_torch_cuda_kernels.py drives them
    with pytest.raises((RuntimeError, AssertionError)):
        gen.assemble(headers, payloads)
    with pytest.raises((RuntimeError, AssertionError)):
        OFDMFrameSync(cfg, 32).demod_aligned(iq.numpy())
    with pytest.raises((RuntimeError, AssertionError)):
        OFDMFrameSync(cfg, 32).receive_block(iq.reshape(-1))
    with pytest.raises((RuntimeError, AssertionError)):
        modem.constellation("qam4")


def test_profile_stage_attribution():
    """The link profile charges a device operation to every host range that
    holds the call launching it (nested ranges both), matched by
    correlation id, and not by where the operation runs on the card."""
    from cognitive_radio_network_tpu_torch.profile_link import stage_device_times

    def x(cat, name, ts, dur, tid=1, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": tid,
                "args": args}

    trace = {"traceEvents": [
        x("user_annotation", "outer", 0, 100),
        x("user_annotation", "inner", 10, 20),
        x("cuda_runtime", "cudaLaunchKernel", 15, 2, correlation=1),
        x("cuda_runtime", "cudaLaunchKernel", 50, 2, correlation=2),
        x("cuda_runtime", "cudaLaunchKernel", 150, 2, correlation=3),  # after both ranges
        x("cuda_runtime", "cudaLaunchKernel", 20, 2, tid=2, correlation=4),  # other thread
        x("kernel", "k1", 500, 7.5, tid=7, correlation=1),  # runs long after its launch
        x("gpu_memset", "fill", 600, 1.0, tid=7, correlation=2),
        x("kernel", "k3", 700, 3.0, tid=7, correlation=3),
        x("kernel", "k4", 800, 4.0, tid=7, correlation=4),
        {"ph": "s", "cat": "ac2g", "id": 1, "ts": 15, "pid": 0, "tid": 1},
    ]}
    got = stage_device_times(trace, ["outer", "inner", "absent"])
    assert got == {"outer": (1, 100.0, 8.5, 2), "inner": (1, 20.0, 7.5, 1),
                   "absent": (0, 0.0, 0.0, 0)}
