"""Port parity: the spectrum analyzer, GMSK frames, timers and profiling helpers.

The same numpy arrays go through the port and the JAX package.  Waterfall
and PSD in dB: atol 1e-4 dB (a power ratio of 2.3e-5: float32 DFT products
summed in another order).  GMSK: the port within atol 1e-5 of a float64
numpy oracle of the same modulator; against the JAX package within atol 5e-5,
because the JAX package's float32 ``cumsum`` of the frequency pulse drifts by
more than 1e-5 rad from the exact phase over a long frame (the port
integrates the phase in float64), and the port is held to be at least as
close to the oracle as the JAX package is.  The reference's own analyzer tests
(tests/test_io_tools.py::TestSpectrumAnalyzer, TestLiveMonitor) run on the
port as they are.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cognitive_radio_network_tpu.phy import gmsk as jax_gmsk
from cognitive_radio_network_tpu.tools import spectrum_analyzer as jsa
from cognitive_radio_network_tpu_torch.env.scene import occupancy_to_powers, synthesize_scene
from cognitive_radio_network_tpu_torch.io.iq import IQWriter
from cognitive_radio_network_tpu_torch.phy import gmsk
from cognitive_radio_network_tpu_torch.signal import filters
from cognitive_radio_network_tpu_torch.tools import spectrum_analyzer as sa
from cognitive_radio_network_tpu_torch.utils import profiling
from cognitive_radio_network_tpu_torch.utils.timer import Timer

ROOT = Path(__file__).resolve().parents[1]


# --- waterfall and PSD against the JAX package ------------------------------


@pytest.mark.parametrize(
    "kw,n",
    [
        (dict(fft_length=256, average=4, sample_rate_hz=1e6, center_hz=0.0), 256 * 4 * 6 + 100),
        (dict(), 1024 * 8 * 3),  # BAND_800M
        (dict(fft_length=128, average=2, window="hamming"), 4096),
        (dict(fft_length=64, average=3, window="none"), 2000),
    ],
    ids=["blackman-256", "band-800M", "hamming-128", "rect-64"],
)
def test_waterfall_and_psd_match_jax(rng, kw, n):
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    x += np.exp(2j * np.pi * 0.1 * np.arange(n)).astype(np.complex64)
    jcfg, cfg = jsa.SpectrumConfig(**kw), sa.SpectrumConfig(**kw)
    want_wf = np.asarray(jsa.waterfall(jnp.asarray(x), jcfg))
    want_psd = np.asarray(jsa.psd(jnp.asarray(x), jcfg))
    planes = np.stack([x.real, x.imag], axis=-1)
    for form in (torch.from_numpy(x), planes, torch.from_numpy(planes)):
        wf = sa.waterfall(form, cfg)
        assert wf.dtype == torch.float32 and wf.device.type == "cpu"
        np.testing.assert_allclose(wf.numpy(), want_wf, atol=1e-4, rtol=0)
    np.testing.assert_allclose(sa.psd(planes, cfg).numpy(), want_psd, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(sa.freq_axis_hz(cfg), jsa.freq_axis_hz(jcfg))
    art = sa.render_ascii(sa.waterfall(planes, cfg))
    assert len(art.splitlines()) == len(jsa.render_ascii(want_wf).splitlines())


# --- tests/test_io_tools.py::TestSpectrumAnalyzer on the port -------------


def test_waterfall_tone(rng):
    cfg = sa.SpectrumConfig(fft_length=256, average=4, sample_rate_hz=1e6, center_hz=0.0)
    n = 256 * 4 * 6
    tone = np.exp(2j * np.pi * 0.25 * np.arange(n)).astype(np.complex64)
    tone += 0.001 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    wf = sa.waterfall(torch.from_numpy(tone), cfg).numpy()
    assert wf.shape == (6, 256)
    peak_bin = wf.mean(axis=0).argmax()
    f = sa.freq_axis_hz(cfg)
    assert abs(f[peak_bin] - 0.25e6) < 2 * 1e6 / 256


def test_psd_and_ascii(rng):
    cfg = sa.SpectrumConfig(fft_length=128, average=2, sample_rate_hz=1e6)
    x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)).astype(np.complex64)
    p = sa.psd(torch.from_numpy(x), cfg).numpy()
    assert p.shape == (128,)
    art = sa.render_ascii(sa.waterfall(torch.from_numpy(x), cfg).numpy())
    assert len(art.splitlines()) >= 1


def test_700M_variant_defaults():
    assert sa.BAND_700M.center_hz == 766e6
    assert sa.BAND_700M.sample_rate_hz == 10e6
    assert sa.BAND_800M == sa.SpectrumConfig()


# --- tests/test_io_tools.py::TestLiveMonitor on the port -------------------


def _monitor():
    return sa.LiveMonitor(sa.scene_source(torch.Generator().manual_seed(3)), sa.BAND_800M,
                          height=8, device="cpu")


def test_keys_retune_like_the_reference_gui():
    m = _monitor()
    f0, r0 = m.cfg.center_hz, m.cfg.sample_rate_hz
    m.handle_key("F")
    assert m.cfg.center_hz == f0 + m.FREQ_STEP_HZ
    m.handle_key("f")
    m.handle_key("f")
    assert m.cfg.center_hz == f0 - m.FREQ_STEP_HZ
    m.handle_key("R")
    assert m.cfg.sample_rate_hz == 2 * r0
    m.handle_key("r")
    m.handle_key("r")
    assert m.cfg.sample_rate_hz == r0 / 2
    m.handle_key("g")
    assert m.gain_db == -5.0
    m.handle_key("G")
    m.handle_key("G")
    assert m.gain_db == 5.0
    m.handle_key(" ")
    assert m.paused
    m.handle_key("q")
    assert m.done


def test_step_renders_and_advances():
    m = _monitor()
    frame1 = m.step(width=60)
    assert "fc=833.0 MHz" in frame1
    assert "rate=13.0 MS/s" in frame1
    rows_after = m._rows.copy()
    # paused: the waterfall freezes while the header updates
    m.handle_key(" ")
    frame2 = m.step(width=60)
    assert "[PAUSED]" in frame2
    np.testing.assert_array_equal(m._rows, rows_after)
    # resume + retune: the header follows the new tuning
    m.handle_key(" ")
    m.handle_key("F")
    frame3 = m.step(width=60)
    assert "fc=834.0 MHz" in frame3
    assert not np.array_equal(m._rows, rows_after)
    body = frame3.split("\n", 1)[1]
    assert any(c != " " for c in body)


def test_run_headless_without_tty(capsys):
    # stdin is not a tty under pytest: run() prints plain frames and stops at max_steps
    m = _monitor()
    m.run(max_steps=2, interval_s=0.0)
    out = capsys.readouterr().out
    assert out.count("fc=833.0 MHz") == 2


def test_monitor_moves_a_numpy_source_to_its_device():
    blocks = []

    def src(cfg, n):
        blk = np.zeros((n, 2), np.float32)
        blk[:, 0] = 1.0
        blocks.append(blk)
        return blk

    m = sa.LiveMonitor(src, sa.SpectrumConfig(fft_length=64, average=2), height=4, device="cpu")
    m.step()
    assert len(blocks) == 1 and m._rows.shape == (4, 64)
    assert m._rows[-1].argmax() == 32  # DC sits mid-axis after the shift


# --- the spectrum CLI, headless ---------------------------------------------


def _cli(*args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "cognitive_radio_network_tpu_torch", *args],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )


def test_spectrum_cli_on_a_capture_finds_the_pu_channel(tmp_path):
    """A capture with the PU parked on CH2 (835 MHz): the saved waterfall's
    time-averaged peak lies inside that channel's 1.4 MHz band."""
    cycles = 8
    powers = occupancy_to_powers(torch.full((cycles,), 1), 3, power=0.1)
    planes = synthesize_scene(torch.Generator().manual_seed(4), powers, 1024 * 8, as_planes=True)
    cap = tmp_path / "cap.iq"
    with IQWriter(cap, 13e6, 833e6) as w:
        w.write(planes.reshape(-1, 2).numpy())
    out = tmp_path / "wf.npz"
    from cognitive_radio_network_tpu_torch.__main__ import main as cli_main

    rc = cli_main(["spectrum", str(cap), "--out", str(out), "--device", "cpu"])
    assert rc == 0
    with np.load(out) as d:
        wf, f = d["waterfall_db"], d["freq_hz"]
    assert wf.shape == (cycles, 1024) and np.isfinite(wf).all()
    peak = f[(10 ** (wf / 10)).mean(0).argmax()]
    assert abs(peak - 835e6) < 0.7e6, peak


def test_spectrum_cli_demo_in_a_process(tmp_path):
    proc = _cli("spectrum", "demo", "--fft", "256", "--device", "cpu", "--out",
                str(tmp_path / "d.npz"), cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "freq 826.5..839.4 MHz, 24 rows"
    with np.load(tmp_path / "d.npz") as d:
        assert d["waterfall_db"].shape == (24, 256)


@pytest.mark.skipif("torch.cuda.is_available()", reason="checks the refusal with no card")
def test_spectrum_cli_defaults_to_the_card_and_refuses_without_one(tmp_path):
    proc = _cli("spectrum", "demo", "--out", str(tmp_path / "d.npz"), cwd=tmp_path)
    assert proc.returncode != 0 and "device cuda is not available" in proc.stderr
    assert not (tmp_path / "d.npz").exists()
    with pytest.raises(RuntimeError, match="cuda is not available"):
        sa.main(["demo", "--live", "--steps", "1"])


# --- GMSK -------------------------------------------------------------------


def _gmsk_f64(bits, sps=4, bt=0.3):
    """The modulator in float64 numpy: NRZ impulses, Gaussian filter, phase
    integrated at pi/2 per bit."""
    up = np.zeros(len(bits) * sps)
    up[::sps] = 2.0 * np.asarray(bits, np.float64) - 1.0
    freq = np.convolve(up, filters.gaussian_taps(sps, 3, bt).astype(np.float64), mode="same")
    return np.exp(1j * np.cumsum(freq) * np.pi / 2.0)


@pytest.mark.parametrize("n_bits,sps", [(200, 4), (3000, 4), (500, 8)])
def test_gmsk_modulate_matches_the_oracle_and_jax(n_bits, sps):
    bits = np.random.default_rng(n_bits).integers(0, 2, n_bits)
    got = gmsk.gmsk_modulate(bits, sps, device="cpu")
    assert got.dtype == torch.complex64 and got.shape == (n_bits * sps,)
    want = _gmsk_f64(bits, sps)
    jax_out = np.asarray(jax_gmsk.gmsk_modulate(bits, sps))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), jax_out, atol=5e-5, rtol=0)
    assert np.abs(got.numpy() - want).max() <= np.abs(jax_out - want).max() + 1e-6
    np.testing.assert_allclose(np.abs(got.numpy()), 1.0, atol=1e-6)  # constant envelope


@pytest.mark.parametrize("payload_len,sps,gain_db", [(50, 4, 0.0), (200, 8, -6.0), (8, 2, 3.0)])
def test_gmsk_frame_matches_jax(payload_len, sps, gain_db):
    got = gmsk.gmsk_frame(np.random.default_rng(payload_len), payload_len, sps, gain_db,
                          device="cpu")
    want = np.asarray(jax_gmsk.gmsk_frame(np.random.default_rng(payload_len), payload_len, sps,
                                          gain_db))
    assert got.dtype == torch.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)
    np.testing.assert_allclose(np.abs(got.numpy()), 10 ** (gain_db / 20), rtol=1e-5)
    assert gmsk.GMSK_HEADER_LEN == jax_gmsk.GMSK_HEADER_LEN == 8
    assert gmsk.GMSK_PAYLOAD_LEN == jax_gmsk.GMSK_PAYLOAD_LEN == 50


def test_gmsk_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal with no card")
    with pytest.raises((AssertionError, RuntimeError)):
        gmsk.gmsk_modulate(np.ones(8, np.uint8))


# --- timers and profiling -----------------------------------------------------


def test_timer_tic_toc():
    t = Timer()
    time.sleep(0.01)
    first = t.toc()
    assert first >= 0.01 and t.toc() >= first  # toc does not reset
    t.tic()
    assert t.toc() < first


def test_device_time_keys_on_the_cpu():
    calls = []
    x = torch.ones(64)

    def fn(v):
        calls.append(1)
        return v * 2

    out = profiling.device_time(fn, x, reps=5, warmup=1)
    assert set(out) == {"mean_s", "p50_s", "total_s", "reps"}
    assert out["reps"] == 5 and len(calls) == 6
    assert out["total_s"] >= 0 and out["mean_s"] == pytest.approx(out["total_s"] / 5)
    assert out["p50_s"] == out["mean_s"]
    assert profiling.device_time(fn, x, reps=2, warmup=0)["reps"] == 2


def test_drain_and_trace_on_the_cpu(tmp_path):
    profiling.drain({"a": torch.ones(2), "b": [torch.zeros(1), (torch.ones(1),)], "c": 3})
    with profiling.trace(tmp_path / "tr") as prof:
        torch.ones(256).sum()
    assert prof is not None
    text = (tmp_path / "tr" / "trace.json").read_text()
    assert '"traceEvents"' in text
