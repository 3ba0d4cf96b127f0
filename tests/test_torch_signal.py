"""Port parity: ``cognitive_radio_network_tpu_torch.signal`` vs the JAX signal core.

Inputs are numpy arrays handed to both packages; the JAX side runs on the CPU.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cognitive_radio_network_tpu.signal import bands as jbands
from cognitive_radio_network_tpu.signal import detector as jdet
from cognitive_radio_network_tpu.signal import fft as jfft
from cognitive_radio_network_tpu.signal import filters as jfilters
from cognitive_radio_network_tpu.signal import iq as jiq
from cognitive_radio_network_tpu.signal import mlp as jmlp
from cognitive_radio_network_tpu_torch.signal import bands as tbands
from cognitive_radio_network_tpu_torch.signal import detector as tdet
from cognitive_radio_network_tpu_torch.signal import fft as tfft
from cognitive_radio_network_tpu_torch.signal import filters as tfilters
from cognitive_radio_network_tpu_torch.signal import iq as tiq
from cognitive_radio_network_tpu_torch.signal import mlp as tmlp

import golden_reference as gold


def _random_iq(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


class TestFFT:
    @pytest.mark.parametrize("precision", ["highest", "high"])
    @pytest.mark.parametrize("mode", ["dft_matmul", "ct_matmul", "xla"])
    @pytest.mark.parametrize("n", [256, 512])
    def test_averaged_spectrum_matches_jax(self, rng, mode, precision, n):
        planes = rng.standard_normal((3, 10, n, 2)).astype(np.float32)
        want = jfft.averaged_magnitude_spectrum(
            jnp.asarray(planes), averaging=10, mode=mode, precision=precision
        )
        got = tfft.averaged_magnitude_spectrum(
            torch.from_numpy(planes), averaging=10, mode=mode, precision=precision
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)

    def test_input_forms_agree(self, rng):
        x = _random_iq(rng, (4, 512))
        planes = np.stack([x.real, x.imag], -1)
        by_complex = tfft.spectrum_magnitude(torch.from_numpy(x), mode="ct_matmul")
        by_planes = tfft.spectrum_magnitude(torch.from_numpy(planes), mode="ct_matmul")
        by_planar = tfft.spectrum_magnitude(
            (torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy())), mode="ct_matmul"
        )
        np.testing.assert_array_equal(by_complex.numpy(), by_planes.numpy())
        np.testing.assert_array_equal(by_complex.numpy(), by_planar.numpy())
        np.testing.assert_allclose(
            by_complex.numpy(), np.abs(np.fft.fft(x, axis=-1)), rtol=1e-4, atol=1e-4
        )

    def test_tables_equal_jax_tables(self):
        for got, want in zip(tfft.dft_matrices(128), jfft.dft_matrices(128)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for got, want in zip(tfft._ct_twiddles_np(4, 128), jfft._ct_twiddles_np(4, 128)):
            np.testing.assert_array_equal(got, want)

    def test_rejects_unknown_mode_and_averaging_mismatch(self, rng):
        x = torch.from_numpy(_random_iq(rng, (2, 10, 512)))
        with pytest.raises(ValueError, match="mode"):
            tfft.spectrum_magnitude(x, mode="fftw")
        with pytest.raises(ValueError, match="averaging"):
            tfft.averaged_magnitude_spectrum(x, averaging=8)


class TestBands:
    def test_band_matrix_equals_jax_with_bin_511_quirk(self):
        m = tbands.band_matrix().numpy()
        np.testing.assert_array_equal(m, np.asarray(jbands.band_matrix()))
        assert m[:, 1].sum() == 31 and m[511, 1] == 0 and m[510, 1] == 1

    def test_for_grid_equals_jax(self):
        kw = dict(
            fft_length=512,
            sample_rate_hz=13e6,
            center_hz=833e6,
            channels_hz=(833e6, 835e6, 838e6),
            channel_bw_hz=0.8e6,
            noise_offset_hz=-2.5e6,
        )
        t, j = tbands.SensingBands.for_grid(**kw), jbands.SensingBands.for_grid(**kw)
        assert t.columns == j.columns and len(t.ch1) == 2
        np.testing.assert_array_equal(
            tbands.band_matrix(t).numpy(), np.asarray(jbands.band_matrix(j))
        )

    def test_band_features_match_jax_and_golden(self, rng):
        spec = np.abs(rng.standard_normal((6, 512))).astype(np.float32) * 20
        got = tbands.band_features(torch.from_numpy(spec)).numpy()
        np.testing.assert_allclose(
            got, np.asarray(jbands.band_features(jnp.asarray(spec))), rtol=1e-5
        )
        want = np.stack([gold.band_features_reference(s) for s in spec])
        np.testing.assert_allclose(got, want, rtol=1e-5)


class TestMLP:
    def test_reference_weights_match_jax(self, rng):
        jp = jmlp.reference_weights()
        port = tmlp.params_from_numpy(*(np.asarray(v) for v in jp))
        ref = tmlp.reference_weights()
        for name, want in zip(("w1", "b1", "w2", "b2"), jp):
            np.testing.assert_array_equal(getattr(port, name).detach().numpy(), np.asarray(want))
            np.testing.assert_array_equal(getattr(ref, name).detach().numpy(), np.asarray(want))
        feats = (np.abs(rng.standard_normal((50, 4))) * np.array([1e-2, 10, 10, 10])).astype(
            np.float32
        )
        want = np.asarray(jmlp.mlp_forward(jp, jnp.asarray(feats)))
        with torch.no_grad():
            got = tmlp.mlp_forward(port, torch.from_numpy(feats)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)

    def test_module_layout(self):
        m = tmlp.OccupancyMLP()
        assert tuple(m.w1.shape) == (4, 5) and tuple(m.b1.shape) == (5,)
        assert tuple(m.w2.shape) == (5, 3) and tuple(m.b2.shape) == (3,)
        assert len(list(m.parameters())) == 4


class TestDetector:
    def test_decisions_equal_jax(self, rng):
        outs = rng.uniform(0, 1, size=(200, 3)).astype(np.float32)
        outs[:4] = [[0.9, 0.9, 0.9], [0.1, 0.8, 0.9], [0.1, 0.1, 0.8], [0.79, 0.79, 0.79]]
        got = tdet.occupancy_decision(torch.from_numpy(outs))
        want = np.asarray(jdet.occupancy_decision(jnp.asarray(outs)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy()[:4], [1, 2, 3, 0])

    def test_next_channel_equals_jax(self):
        d = np.array([0, 1, 2, 3, 0], np.int32)
        cur = np.full((5,), 838e6, np.float32)
        got = tdet.next_tx_channel(torch.from_numpy(d), torch.from_numpy(cur))
        want = np.asarray(jdet.next_tx_channel(jnp.asarray(d), jnp.asarray(cur)))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


class TestFiltersAndIQ:
    @pytest.mark.parametrize(
        "name, args",
        [
            ("rrcos_taps", (4, 3, 0.35)),
            ("gaussian_taps", (4, 3, 0.3)),
            ("kaiser_lowpass_taps", (129, 0.7e6 / 13e6, 60.0)),
            ("channelizer_prototype", (64, 8)),
            ("blackman_harris", (512,)),
            ("hamming", (64,)),
        ],
    )
    def test_filters_equal(self, name, args):
        np.testing.assert_array_equal(
            getattr(tfilters, name)(*args), getattr(jfilters, name)(*args)
        )

    def test_iq_forms(self, rng):
        x = _random_iq(rng, (3, 8))
        planes = tiq.to_planes(x)
        np.testing.assert_array_equal(planes, jiq.to_planes(x))
        np.testing.assert_array_equal(tiq.from_planes(planes), x)
        back = tiq.from_planes(torch.from_numpy(planes))
        np.testing.assert_array_equal(back.numpy(), x)
        tx = torch.from_numpy(x)
        for form in (x, planes, (x.real, x.imag), tx, torch.from_numpy(planes), (tx.real, tx.imag)):
            xr, xi = tiq.split_iq(form)
            np.testing.assert_array_equal(xr.numpy(), x.real)
            np.testing.assert_array_equal(xi.numpy(), x.imag)
            assert xr.is_contiguous() and xi.is_contiguous()  # the kernels take contiguous planes
        with pytest.raises(ValueError, match="IQ input"):
            tiq.split_iq(torch.zeros(3, 4))
