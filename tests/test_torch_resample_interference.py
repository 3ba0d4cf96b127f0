"""Port vs JAX package: polyphase resampling and interferer synthesis.

The host numpy resampler is a copy and must be bit-equal; the device
resampler (one gather and one matmul) is held to the reference's
``resample_poly_jnp`` at rtol 1e-5 / atol 1e-6 (float32 summation order).
Interferer waveforms come from ``torch.Generator`` draws where the reference
uses ``jax.random``, so they are held by their statistics; the duty-cycle
gate and the deterministic hop traces ("fixed", "sweep") must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cognitive_radio_network_tpu.env import interference as jint
from cognitive_radio_network_tpu.signal import resample as jres
from cognitive_radio_network_tpu_torch.env import interference as tint
from cognitive_radio_network_tpu_torch.signal import resample as tres

RATIOS = [(65, 7), (13, 1), (1, 16), (4, 1)]


@pytest.mark.parametrize("up,down", RATIOS)
@pytest.mark.parametrize("kind", ["complex_1d", "float_2d"])
def test_resample_poly_host_is_bit_equal(up, down, kind):
    rng = np.random.default_rng(up * 100 + down)
    if kind == "complex_1d":
        x = (rng.standard_normal(3001) + 1j * rng.standard_normal(3001)).astype(np.complex64)
    else:
        x = rng.standard_normal((3, 2000)).astype(np.float32)
    got = tres.resample_poly(x, up, down)
    want = jres.resample_poly(x, up, down)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("up,down", RATIOS)
def test_resample_poly_torch_matches_jnp(up, down):
    rng = np.random.default_rng(7 + up)
    x = rng.standard_normal((4, 4864)).astype(np.float32)
    got = tres.resample_poly_torch(torch.from_numpy(x), up, down).numpy()
    want = np.asarray(jres.resample_poly_jnp(jnp.asarray(x), up, down))
    assert got.shape == want.shape == (4, -(-4864 * up // down))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_halfband_interp_is_bit_equal():
    x = np.random.default_rng(3).standard_normal(777).astype(np.float32)
    np.testing.assert_array_equal(tres.halfband_interp(x), jres.halfband_interp(x))


def _pair(**kw):
    return jint.InterfererConfig(**kw), tint.InterfererConfig(**kw)


@pytest.mark.parametrize(
    "period,duty,rate,n",
    [(1.0, 1.0, 1e6, 5000), (0.01, 0.5, 16e6, 400_000), (1e-3, 0.3, 13e6, 65_536), (2e-4, 0.01, 1e6, 3000)],
)
def test_duty_cycle_gate_is_equal(period, duty, rate, n):
    jc, tc = _pair(period_s=period, duty_cycle=duty)
    want = np.asarray(jint.duty_cycle_gate(jc, n, rate))
    got = tint.duty_cycle_gate(tc, n, rate, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "kw",
    [
        dict(tx_freq_behavior="fixed", tx_freq_hz=835e6),
        dict(tx_freq_behavior="sweep", tx_freq_hz=833e6, tx_freq_min_hz=833e6,
             tx_freq_max_hz=838e6, tx_freq_resolution_hz=1e6),
        # eight_node.cfg's sweeping noise interferer
        dict(tx_freq_behavior="sweep", tx_freq_hz=459e6, tx_freq_min_hz=458e6,
             tx_freq_max_hz=460e6, tx_freq_resolution_hz=0.5e6),
        dict(tx_freq_behavior="sweep", tx_freq_hz=100.3e6, tx_freq_min_hz=100e6,
             tx_freq_max_hz=101.1e6, tx_freq_resolution_hz=0.137e6),
    ],
    ids=["fixed", "sweep_833_838", "sweep_eight_node", "sweep_odd_step"],
)
def test_hop_trace_deterministic_behaviours_are_equal(kw):
    import jax

    jc, tc = _pair(**kw)
    want = np.asarray(jint.hop_trace(jax.random.key(0), jc, 97))
    got = tint.hop_trace(torch.Generator().manual_seed(0), tc, 97).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if kw["tx_freq_behavior"] == "sweep":  # it hops, and reflects inside the band
        assert len(set(got.tolist())) > 2


def test_hop_trace_random_on_grid_inside_band():
    _, tc = _pair(tx_freq_behavior="random", tx_freq_min_hz=833e6, tx_freq_max_hz=838e6,
                  tx_freq_resolution_hz=1e6)
    tr = tint.hop_trace(torch.Generator().manual_seed(4), tc, 4000).double().numpy()
    assert tr.min() >= 833e6 and tr.max() <= 838e6
    steps = (tr - 833e6) / 1e6
    np.testing.assert_array_equal(steps, np.round(steps))
    assert set(steps.astype(int).tolist()) == set(range(6))


def _band_share(x: np.ndarray, half_width: float) -> float:
    """Share of the power within +-half_width (cycles/sample) of DC."""
    spec = np.abs(np.fft.fft(x)) ** 2
    f = np.fft.fftfreq(len(x))
    return float(spec[np.abs(f) <= half_width].sum() / spec.sum())


# per type: (mean power, tolerance), and the band that must hold >= 90% of it
# (None: white).  The reference's own values, from the same synthesis on
# jax.random draws, must meet the same checks.
STATS = {
    "cw": ((0.5, 1e-6), 0.0),
    "noise": ((2 * 0.25**2 / 3, 0.02), None),
    "awgn": ((2 * (25.0 + 25.0), 0.02), None),
    "rrc": ((None, None), 0.34),
    "gmsk": ((10 ** (-3.0 / 10), 1e-3), 0.2),
    "ofdm": ((None, None), None),
}


@pytest.mark.parametrize("kind", sorted(STATS))
def test_synthesize_interference_statistics(kind):
    import jax

    n = 1 << 16
    jc, tc = _pair(interference_type=kind, tx_rate_hz=1e6)
    got = tint.synthesize_interference(torch.Generator().manual_seed(1), tc, n).numpy()
    want = np.asarray(jint.synthesize_interference(jax.random.key(1), jc, n))
    assert got.dtype == np.complex64 and got.shape == (n,)
    assert np.isfinite(got).all()
    (p_want, tol), band = STATS[kind]
    p_got, p_ref = float(np.mean(np.abs(got) ** 2)), float(np.mean(np.abs(want) ** 2))
    if p_want is not None:
        assert p_got == pytest.approx(p_want, rel=tol)
    # the same power as the reference's draws within 2%
    assert p_got == pytest.approx(p_ref, rel=0.02, abs=1e-7)
    if band is not None:
        assert _band_share(got, band) >= 0.9 and _band_share(want, band) >= 0.9
    else:  # white: an eighth of the band holds about an eighth of the power
        share = _band_share(got - got.mean(), 1 / 16)
        assert share == pytest.approx(_band_share(want - want.mean(), 1 / 16), abs=0.02)
    if kind == "noise":
        assert got.real.min() >= -0.25 and got.real.max() < 0.25
    if kind == "awgn":
        assert got.real.mean() == pytest.approx(5.0, abs=0.1)
        assert got.imag.std() == pytest.approx(5.0, rel=0.02)
