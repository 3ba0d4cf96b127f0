"""Port parity: ``fused_band_features_plain`` (PyTorch) vs the JAX Pallas kernel.

The JAX kernel (ops/fused_sense.py) runs in interpret mode on the CPU through
the ``pallas_call`` patch of tests/test_ops_pallas.py:15-22.  Both sides get
the same numpy arrays.  Bound: rtol 1e-4 (tests/test_ops_pallas.py:29); both
sides are full-float32 products in different summation orders.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

import cognitive_radio_network_tpu.ops.fused_sense as jax_fsops
from cognitive_radio_network_tpu_torch.ops.fused_sense import (
    fused_band_features,
    fused_band_features_plain,
)
from cognitive_radio_network_tpu_torch.ops.fused_sense_ct import fused_sense_ct_plain
from cognitive_radio_network_tpu_torch.signal.bands import SensingBands, band_features
from cognitive_radio_network_tpu_torch.signal.fft import averaged_magnitude_spectrum


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        kw.pop("cost_estimate", None)
        return orig(*args, **kw)

    monkeypatch.setattr(jax_fsops.pl, "pallas_call", interp_call)


def _planar(iq):
    return tuple(
        torch.from_numpy(np.ascontiguousarray(iq[..., i]).reshape(-1, 512)) for i in (0, 1)
    )


@pytest.mark.parametrize("cycles,averaging", [(16, 10), (8, 4)])
def test_plain_matches_jax_kernel(rng, interpret_pallas, cycles, averaging):
    iq = rng.standard_normal((cycles, averaging, 512, 2)).astype(np.float32)
    want = np.asarray(jax_fsops.fused_band_features(jnp.asarray(iq), tile_c=8))
    got = fused_band_features_plain(torch.from_numpy(iq))
    assert got.shape == (cycles, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)


@pytest.mark.parametrize("cycles", [5, 16])
def test_plain_matches_spectrum_and_band_features(rng, cycles):
    """The drop-in contract: averaged_magnitude_spectrum + band_features."""
    iq = torch.from_numpy(rng.standard_normal((cycles, 10, 512, 2)).astype(np.float32))
    want = band_features(averaged_magnitude_spectrum(iq, precision="highest"))
    np.testing.assert_allclose(fused_band_features_plain(iq).numpy(), want.numpy(), rtol=1e-4)


def test_plain_matches_fused_sense_ct_features(rng):
    """Kernel 1's feature output has the same contract."""
    iq = rng.standard_normal((6, 10, 512, 2)).astype(np.float32)
    xr, xi = _planar(iq)
    _, want = fused_sense_ct_plain(xr, xi, averaging=10, precision="highest")
    np.testing.assert_allclose(fused_band_features_plain((xr, xi)).numpy(), want.numpy(), rtol=1e-4)


@pytest.mark.parametrize("form", ["planar-2d", "planar-3d"])
def test_planar_forms_equal_planes(rng, form):
    iq = rng.standard_normal((4, 10, 512, 2)).astype(np.float32)
    want = fused_band_features_plain(torch.from_numpy(iq))
    xr, xi = _planar(iq)
    if form == "planar-3d":
        xr, xi = xr.reshape(4, 10, 512), xi.reshape(4, 10, 512)
    got = fused_band_features_plain((xr, xi), averaging=10)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_any_cycle_count_and_other_bands(rng):
    """No tile_c: any C is valid, C = 0 included; bands follow the argument."""
    iq = torch.from_numpy(rng.standard_normal((3, 2, 512, 2)).astype(np.float32))
    assert fused_band_features(iq).shape == (3, 4)
    assert fused_band_features(iq[:0]).shape == (0, 4)
    bands = SensingBands(noise_floor=((100, 120),))
    want = band_features(averaged_magnitude_spectrum(iq, precision="highest"), bands)
    np.testing.assert_allclose(
        fused_band_features(iq, bands=bands).numpy(), want.numpy(), rtol=1e-4
    )


def test_wrapper_on_cpu_runs_plain_version(rng):
    """A CPU tensor takes the plain version, bit for bit, and launches nothing."""
    iq = torch.from_numpy(rng.standard_normal((3, 10, 512, 2)).astype(np.float32))
    before = fused_band_features.launches
    got = fused_band_features(iq)
    assert fused_band_features.launches == before
    assert torch.equal(got, fused_band_features_plain(iq))


@pytest.mark.parametrize("fn", [fused_band_features, fused_band_features_plain])
@pytest.mark.parametrize(
    "shape,averaging,match",
    [
        ((2, 10, 256, 2), 10, "N=512"),
        ((20, 512), 10, r"expected \(C, A, N, 2\)"),
        ((2, 10, 512, 3), 10, r"expected \(C, A, N, 2\)"),
    ],
)
def test_rejects_planes(fn, shape, averaging, match):
    with pytest.raises(ValueError, match=match):
        fn(torch.zeros(shape), averaging=averaging)


@pytest.mark.parametrize("fn", [fused_band_features, fused_band_features_plain])
def test_rejects_planar(fn):
    x = torch.zeros(25, 512)
    with pytest.raises(ValueError, match="not divisible"):
        fn((x, x), averaging=10)
    with pytest.raises(ValueError, match="differ in shape"):
        fn((x, x[:20]), averaging=10)
    with pytest.raises(ValueError, match=r"expected \(C\*A, N\)"):
        fn((x[0], x[0]), averaging=1)
