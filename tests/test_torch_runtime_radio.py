"""Port vs JAX package: the radio runtime (tx chain, rx front end and
adaptive receiver) and the interferer node, on the same numpy inputs.

The tx chain runs on the radio's device in the port (the CPU here): the
samples are held to the reference's at rtol 1e-4 / atol 1e-5, the float32
rounding of two IFFT and resampling implementations.  The rx front end is
numpy in both packages and the receiver is held exactly: frame numbers,
payload bytes, valid flags and the statistics counts must be equal."""

import dataclasses

import numpy as np
import pytest

from cognitive_radio_network_tpu.env.interference import InterfererConfig as JIC
from cognitive_radio_network_tpu.runtime.engine import CEEvent as JEvent
from cognitive_radio_network_tpu.runtime.node import InterfererNode as JInterferer
from cognitive_radio_network_tpu.runtime.radio import Radio as JRadio
from cognitive_radio_network_tpu_torch.env.interference import InterfererConfig as TIC
from cognitive_radio_network_tpu_torch.runtime.engine import CEEvent as TEvent
from cognitive_radio_network_tpu_torch.runtime.node import InterfererNode as TInterferer
from cognitive_radio_network_tpu_torch.runtime.radio import Radio as TRadio


def _radios(medium_rate, **params):
    out = []
    for cls in (TRadio, JRadio):
        r = cls(medium_rate, 465e6, 0, **({"device": "cpu"} if cls is TRadio else {}))
        for k, v in params.items():
            setattr(r.params, k, v)
        out.append(r)
    return out


# (medium rate, tx params): the link's 4/1, predictive_model.cfg's PU at
# 65/7, the predictive SU's qam16/v27/v27 at 13/1, and no resampling
TX_CASES = {
    "qam4_h128_4to1": (4e6, dict(tx_rate=1e6)),
    "pu_65to7": (13e6, dict(tx_rate=1.4e6, tx_gain=10.0)),
    "qam16_v27_13to1": (13e6, dict(tx_rate=1e6, tx_modulation="qam16", tx_fec0="v27",
                                   tx_fec1="v27", tx_gain=5.0)),
    "bpsk_none_1to1": (1e6, dict(tx_rate=1e6, tx_modulation="bpsk", tx_fec0="none",
                                 tx_crc="crc16", tx_gain_soft=-3.0)),
}


@pytest.mark.parametrize("case", sorted(TX_CASES))
@pytest.mark.parametrize("frames", [1, 3])
def test_make_frames_batch_matches_jax(case, frames):
    rate, params = TX_CASES[case]
    got_r, want_r = _radios(rate, **params)
    rng = np.random.default_rng(frames)
    payloads = [rng.integers(0, 256, 64).astype(np.uint8) for _ in range(frames)]
    types = [0, 1, 0][:frames]
    for r in (got_r, want_r):
        r.frame_num = 77
        r.set_control_info(np.arange(6, dtype=np.uint8) * 3)
    got = got_r._make_frames_batch(types, payloads)
    want = want_r._make_frames_batch(types, payloads)
    assert got.dtype == want.dtype == np.complex64
    assert got.shape == want.shape
    assert got.shape[1] == got_r._frame_len_medium(64)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert got_r.frame_num == want_r.frame_num == 77 + frames


def _frames(ev_list, event):
    return [e for e in ev_list if e.ce_event == event]


@pytest.mark.parametrize("scan_blocks", [1, 3])
def test_push_rx_block_matches_jax(scan_blocks):
    """The same medium blocks (the JAX radio's own transmissions, mixed to an
    offset, plus silent blocks and receiver noise) through both receivers."""
    tx = JRadio(4e6, 465e6, 5)
    tx.params.tx_rate, tx.params.tx_freq = 1e6, 466e6
    tx.start_tx()
    rng = np.random.default_rng(11)
    block, blocks = 16384, []
    for k in range(14):
        if k in (4, 5, 9):
            blocks.append(None)  # nothing heard: squelch path
            continue
        if k % 3 != 2:
            for _ in range(3):
                tx.enqueue_packet(rng.integers(0, 256, 256).astype(np.uint8))
        blocks.append(tx.pull_tx_block(block))
    got_r, want_r = _radios(4e6, rx_rate=1e6, rx_freq=466e6)
    for r in (got_r, want_r):
        r.rx_noise_power = 1e-7
        r.noise_seed = (0, 1)
        r.rx_scan_accumulate = scan_blocks
        r.start_rx()
    for k, b in enumerate(blocks):
        for r in (got_r, want_r):
            r.push_rx_block(b, k * 4.096e-3, block)
    for r in (got_r, want_r):
        r.flush_rx_scan(len(blocks) * 4.096e-3)
    got = _frames(got_r.drain_events(), TEvent.PHY_FRAME_RECEIVED)
    want = _frames(want_r.drain_events(), JEvent.PHY_FRAME_RECEIVED)
    assert len(want) >= 6
    assert [(f.frame_num, f.frame_type, f.header_valid, f.payload_valid, f.time_s) for f in got] == [
        (f.frame_num, f.frame_type, f.header_valid, f.payload_valid, f.time_s) for f in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.payload, b.payload)
        np.testing.assert_array_equal(a.header, b.header)
        assert a.stats.evm == pytest.approx(b.stats.evm, abs=0.5)
    assert [n for n, _ in got_r.rx_packet_sink] == [n for n, _ in want_r.rx_packet_sink]
    gs, ws = got_r.get_rx_stats(0.06), want_r.get_rx_stats(0.06)
    assert (gs.frames_received, gs.valid_frames, gs.uhd_overflows) == (
        ws.frames_received, ws.valid_frames, ws.uhd_overflows)
    assert gs.ber_uncoded == ws.ber_uncoded
    assert got_r._rx._residual_offset == want_r._rx._residual_offset
    assert got_r._rx_noise_floor == want_r._rx_noise_floor


def test_sensing_tap_and_squelch_match_jax():
    got_r, want_r = _radios(13e6, rx_rate=13e6, rx_freq=465e6)
    for r in (got_r, want_r):
        r.rx_noise_power = 1e-6
        r.noise_seed = (0, 1)
        r.set_ce_usrp_rx_buffer_length(512)
        r.set_ce_sensing(1)
    for k in range(8):
        for r in (got_r, want_r):
            r.push_rx_block(None, k * 1e-3, 5000)
    got = _frames(got_r.drain_events(), TEvent.USRP_RX_SAMPS)
    want = _frames(want_r.drain_events(), JEvent.USRP_RX_SAMPS)
    assert len(got) == len(want) == 8 * 5000 // 512
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.payload, b.payload)


def _interferers(**kw):
    mk = dict(device="cpu")
    return (TInterferer(7, 16e6, 466e6, TIC(**kw), seed=7, **mk),
            JInterferer(7, 16e6, 466e6, JIC(**kw), seed=7))


def test_cw_interferer_blocks_match_jax():
    """A CW waveform does not depend on the draws, so the gated, mixed
    blocks of eight_node.cfg's CW interferer equal the reference's."""
    got_n, want_n = _interferers(interference_type="cw", tx_freq_hz=473e6, duty_cycle=0.5,
                                 period_s=0.01)
    for node in (got_n, want_n):
        node.start()
    on = 0
    for _ in range(12):
        a, b = got_n.pull_tx_block(65536), want_n.pull_tx_block(65536)
        assert (a is None) == (b is None)
        if a is not None:
            on += 1
            np.testing.assert_array_equal(a, b)
    assert 0 < on < 12


def test_sweep_interferer_hops_like_jax():
    kw = dict(interference_type="noise", tx_freq_behavior="sweep", tx_freq_hz=459e6,
              tx_freq_min_hz=458e6, tx_freq_max_hz=460e6, tx_freq_dwell_s=0.005,
              tx_freq_resolution_hz=0.5e6)
    got_n, want_n = _interferers(**kw)
    for node in (got_n, want_n):
        node.start()
    got_f, want_f, powers = [], [], []
    for _ in range(40):
        a = got_n.pull_tx_block(16384)
        want_n.pull_tx_block(16384)
        got_f.append(got_n.tx_freq)
        want_f.append(want_n.tx_freq)
        powers.append(float(np.mean(np.abs(a) ** 2)))
    assert got_f == want_f
    assert max(got_f) >= 460e6 and min(got_f) <= 458.5e6 and len(set(got_f)) >= 4
    # uniform rails in [-0.25, 0.25): power 2 * 0.25^2 / 3 per sample
    np.testing.assert_allclose(powers, 2 * 0.25**2 / 3, rtol=0.03)


def test_tx_params_and_logs_match_jax():
    from cognitive_radio_network_tpu.runtime.logging import LogSink as JSink
    from cognitive_radio_network_tpu_torch.runtime.logging import LogSink as TSink

    got_r = TRadio(4e6, 465e6, 2, TSink(), device="cpu")
    want_r = JRadio(4e6, 465e6, 2, JSink())
    for r in (got_r, want_r):
        r.set_tx_rate(1e6)
        r.set_tx_freq(464e6)
        r.start_tx()
        for k in range(5):
            r.enqueue_packet(np.full(256, k, np.uint8))
        r.transmit_control_frame(np.full(256, 9, np.uint8))
    for _ in range(9):  # 6 frames of 19,456 medium samples, then silence
        a, b = got_r.pull_tx_block(16384), want_r.pull_tx_block(16384)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    assert got_r.num_tx_frames == want_r.num_tx_frames == 6
    assert got_r.log_sink.phy_tx == want_r.log_sink.phy_tx
    assert dataclasses.asdict(got_r.params) == dataclasses.asdict(want_r.params)
    assert [e.ce_event.name for e in got_r.drain_events()] == [
        e.ce_event.name for e in want_r.drain_events()]
