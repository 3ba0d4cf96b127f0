"""Port parity: ``fused_sense_ct_plain`` (PyTorch) vs the JAX Pallas kernel.

The JAX kernel runs in interpret mode on the CPU, as tests/test_ops_pallas.py
runs it.  Both sides get the same numpy arrays; no seed is shared between the
frameworks.  Bounds are those of tests/test_ops_pallas.py:56-57 and :133-135.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cognitive_radio_network_tpu.ops.fused_sense_ct import ct_band_features as jax_ct_band_features
from cognitive_radio_network_tpu.ops.fused_sense_ct import fused_sense_ct as jax_fused_sense_ct
from cognitive_radio_network_tpu_torch.ops.fused_sense_ct import (
    ct_band_features,
    fused_sense_ct,
    fused_sense_ct_plain,
)


def _planar(iq):
    """(C, A, 512, 2) numpy planes -> contiguous buffers-flat (C*A, 512) planes."""
    return (
        np.ascontiguousarray(iq[..., 0]).reshape(-1, 512),
        np.ascontiguousarray(iq[..., 1]).reshape(-1, 512),
    )


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("cycles", [5, 8])
def test_plain_matches_jax_kernel(rng, cycles, precision):
    iq = rng.standard_normal((cycles, 10, 512, 2)).astype(np.float32)
    want_avg, want_feats = jax_fused_sense_ct(
        jnp.asarray(iq), tile_c=4, precision=precision, interpret=True
    )
    xr, xi = _planar(iq)
    avg, feats = fused_sense_ct_plain(
        torch.from_numpy(xr), torch.from_numpy(xi), averaging=10, precision=precision
    )
    assert avg.shape == (cycles, 512) and feats.shape == (cycles, 4)
    assert avg.dtype == feats.dtype == torch.float32
    np.testing.assert_allclose(avg.numpy(), np.asarray(want_avg), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_feats), rtol=1e-4)


def test_wrapper_on_cpu_runs_plain_version(rng):
    """A CPU tensor takes the plain version, bit for bit, and launches nothing."""
    iq = rng.standard_normal((3, 10, 512, 2)).astype(np.float32)
    xr, xi = (torch.from_numpy(v) for v in _planar(iq))
    before = fused_sense_ct.launches
    got = fused_sense_ct(xr, xi)
    want = fused_sense_ct_plain(xr, xi)
    assert fused_sense_ct.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_planar_2d_equals_interleaved_planes(rng):
    """Buffers-flat planar (C*A, N) input and strided views of interleaved
    (C, A, N, 2) planes give identical results."""
    iq = rng.standard_normal((8, 10, 512, 2)).astype(np.float32)
    xr, xi = _planar(iq)
    a_pl, f_pl = fused_sense_ct_plain(torch.from_numpy(xr), torch.from_numpy(xi))
    t = torch.from_numpy(iq)
    a_il, f_il = fused_sense_ct_plain(t[..., 0], t[..., 1])
    np.testing.assert_array_equal(a_pl.numpy(), a_il.numpy())
    np.testing.assert_array_equal(f_pl.numpy(), f_il.numpy())


def test_bf16_input_default_precision(rng):
    """bf16 planar ingest at precision="default" stays within 2e-2 of the
    f32 result of the JAX kernel."""
    iq = rng.standard_normal((4, 10, 512, 2)).astype(np.float32)
    xr, xi = _planar(iq)
    _, want = jax_fused_sense_ct(
        (jnp.asarray(xr), jnp.asarray(xi)), tile_c=4, interpret=True
    )
    _, got = fused_sense_ct_plain(
        torch.from_numpy(xr).bfloat16(), torch.from_numpy(xi).bfloat16(), precision="default"
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2)


@pytest.mark.parametrize("fn", [fused_sense_ct, fused_sense_ct_plain])
def test_rejects_wrong_fft_length(fn):
    x = torch.zeros(20, 256)
    with pytest.raises(ValueError, match="N=512"):
        fn(x, x, averaging=10)


@pytest.mark.parametrize("fn", [fused_sense_ct, fused_sense_ct_plain])
def test_rejects_rows_not_divisible_by_averaging(fn):
    x = torch.zeros(25, 512)
    with pytest.raises(ValueError, match="not divisible"):
        fn(x, x, averaging=10)


def test_rejects_unknown_precision():
    x = torch.zeros(10, 512)
    with pytest.raises(ValueError, match="precision"):
        fused_sense_ct(x, x, precision="tf32")


@pytest.mark.parametrize("form", ["planar", "interleaved"])
def test_ct_band_features_matches_jax(rng, form):
    """The features alone, from a planar tuple or (C, A, N, 2) planes, within
    the bounds of the features above of the JAX ``ct_band_features`` and
    equal to ``fused_sense_ct``'s."""
    iq = rng.standard_normal((5, 10, 512, 2)).astype(np.float32)
    want = jax_ct_band_features(jnp.asarray(iq), tile_c=4, precision="highest", interpret=True)
    xr, xi = (torch.from_numpy(v) for v in _planar(iq))
    planes = (xr, xi) if form == "planar" else torch.from_numpy(iq)
    got = ct_band_features(planes, precision="highest")
    assert got.shape == (5, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    assert torch.equal(got, fused_sense_ct(xr, xi, precision="highest")[1])
