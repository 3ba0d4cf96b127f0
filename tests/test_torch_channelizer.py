"""Port parity: the polyphase channelizer (PyTorch) vs the JAX package.

Both sides get the same numpy arrays; no seed is shared between the
frameworks.  Bounds are those of tests/test_parallel.py (rtol 1e-4,
atol 1e-5): both sides run float32 products, in different summation orders.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cognitive_radio_network_tpu.signal import channelizer as jch
from cognitive_radio_network_tpu.signal.iq import planes_abs2 as jax_planes_abs2
from cognitive_radio_network_tpu_torch.signal import channelizer as tch
from cognitive_radio_network_tpu_torch.signal.iq import from_planes, planes_abs2, to_planes

RTOL, ATOL = 1e-4, 1e-5


def _stream(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _tone(freq_norm, n):
    return np.exp(2j * np.pi * freq_norm * np.arange(n)).astype(np.complex64)


@pytest.mark.parametrize("m,p", [(64, 8), (16, 8), (8, 4)])
def test_polyphase_taps_equal(m, p):
    got, want = tch.polyphase_taps(m, p), jch.polyphase_taps(m, p)
    assert got.shape == (p, m) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_fir_dft_matrices_match(rng):
    taps = jch.polyphase_taps(16, 8)
    gre, gim = tch._fir_dft_matrices(torch.from_numpy(taps))
    wre, wim = jch._fir_dft_matrices(jnp.asarray(taps))
    np.testing.assert_allclose(gre.numpy(), np.asarray(wre), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(gim.numpy(), np.asarray(wim), rtol=1e-6, atol=1e-9)


def test_frames_match(rng):
    rows = rng.standard_normal((2, 19, 4)).astype(np.float32)
    got = tch._frames(torch.from_numpy(rows), 4)
    assert got.shape == (2, 16, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jch._frames(jnp.asarray(rows), 4)))


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("m,p,t,lead", [(16, 8, 64, ()), (8, 4, 32, (2,)), (64, 8, 32, ())])
def test_channelize_matches_jax(rng, m, p, t, lead, precision):
    taps = jch.polyphase_taps(m, p)
    x = _stream(rng, *lead, t * m)
    want = np.asarray(jch.channelize(jnp.asarray(x), jnp.asarray(taps), precision=precision))
    got = tch.channelize(torch.from_numpy(x), taps, precision=precision)
    assert got.shape == (*lead, t, m) and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_channelize_planes_matches_jax(rng, lead):
    m, p, t = 16, 8, 48
    taps = jch.polyphase_taps(m, p)
    planes = rng.standard_normal((*lead, t * m, 2)).astype(np.float32)
    want = np.asarray(jch.channelize_planes(jnp.asarray(planes), jnp.asarray(taps)))
    got = tch.channelize_planes(torch.from_numpy(planes), torch.from_numpy(taps))
    assert got.shape == (*lead, t, m, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_channelize_with_history_matches_jax(rng):
    m, p, t = 8, 8, 40
    taps = jch.polyphase_taps(m, p)
    x = _stream(rng, t * m)
    hist = _stream(rng, p - 1, m)
    want = np.asarray(
        jch.channelize(jnp.asarray(x), jnp.asarray(taps), history=jnp.asarray(hist))
    )
    got = tch.channelize(torch.from_numpy(x), taps, history=torch.from_numpy(hist))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_channelize_planes_with_history_matches_jax(rng):
    m, p, t = 8, 8, 40
    taps = jch.polyphase_taps(m, p)
    planes = rng.standard_normal((t * m, 2)).astype(np.float32)
    hist = rng.standard_normal((p - 1, m, 2)).astype(np.float32)
    want = np.asarray(
        jch.channelize_planes(jnp.asarray(planes), jnp.asarray(taps), history=jnp.asarray(hist))
    )
    got = tch.channelize_planes(
        torch.from_numpy(planes), taps, history=torch.from_numpy(hist)
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_history_seam(rng):
    """Splitting a stream into blocks with history carry == one shot
    (the case of tests/test_parallel.py::TestChannelizer::test_history_seam)."""
    m, p = 8, 8
    taps = tch.polyphase_taps(m, p)
    x = _stream(rng, 64 * m)
    full = tch.channelize(torch.from_numpy(x), taps).numpy()
    xp = x.reshape(-1, m)
    half = 32
    y1 = tch.channelize(torch.from_numpy(x[: half * m]), taps)
    hist = torch.from_numpy(xp[half - (p - 1) : half])
    y2 = tch.channelize(torch.from_numpy(x[half * m :]), taps, history=hist)
    stitched = np.concatenate([y1.numpy(), y2.numpy()])
    np.testing.assert_allclose(stitched, full, rtol=RTOL, atol=ATOL)
    want = np.asarray(jch.channelize(jnp.asarray(x), jnp.asarray(taps)))
    np.testing.assert_allclose(stitched, want, rtol=RTOL, atol=ATOL)


def test_planes_matches_complex(rng):
    m = 8
    taps = tch.polyphase_taps(m, 8)
    x = _stream(rng, 32 * m)
    yc = tch.channelize(torch.from_numpy(x), taps).numpy()
    yp = tch.channelize_planes(torch.from_numpy(to_planes(x)), taps, precision="highest").numpy()
    np.testing.assert_allclose(from_planes(yp), yc, rtol=RTOL, atol=ATOL)


def test_tone_lands_in_its_channel():
    m, p, t = 16, 8, 256
    k = 5
    y = tch.channelize(torch.from_numpy(_tone(k / m, t * m)), tch.polyphase_taps(m, p)).numpy()
    power = (np.abs(y[p:]) ** 2).mean(axis=0)  # skip the filter's warm-up
    assert power[k] > 0.5
    assert np.delete(power, k).max() < 1e-3 * power[k]


def test_planes_abs2_matches_jax(rng):
    x = rng.standard_normal((3, 7, 2)).astype(np.float32)
    got = planes_abs2(torch.from_numpy(x))
    assert got.shape == (3, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_planes_abs2(jnp.asarray(x))))
