"""Port parity for the fixtures and the entry point of the sense slice:
PU traces, scene synthesis, channel impairments, IQ captures and the
``sense`` CLI.  Random draws differ between torch.Generator and jax.random,
so the environment is held to statistics and the rest to equal arrays.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cognitive_radio_network_tpu.__main__ import main as jax_cli
from cognitive_radio_network_tpu.env import channel as jchannel
from cognitive_radio_network_tpu.env import scene as jscene
from cognitive_radio_network_tpu.io import iq as jiq
from cognitive_radio_network_tpu_torch.__main__ import main as port_cli
from cognitive_radio_network_tpu_torch.env import channel as tchannel
from cognitive_radio_network_tpu_torch.env import pu as tpu
from cognitive_radio_network_tpu_torch.env import scene as tscene
from cognitive_radio_network_tpu_torch.io import iq as tiq
from cognitive_radio_network_tpu_torch.io.checkpoint import save_mlp
from cognitive_radio_network_tpu_torch.signal.mlp import reference_weights


class TestPU:
    @pytest.mark.parametrize(
        "matrix", [tpu.MARKOV_MATRIX_DOCUMENTED, tpu.MARKOV_MATRIX_AS_IMPLEMENTED]
    )
    def test_markov_transition_frequencies(self, matrix):
        trace = tpu.markov_pu_trace(torch.Generator().manual_seed(3), 20_000, matrix)
        assert trace.dtype == torch.int32 and trace.shape == (20_000,) and trace[0] == 0
        t = trace.numpy()
        counts = np.zeros((3, 3))
        np.add.at(counts, (t[:-1], t[1:]), 1)
        for s in range(3):
            if counts[s].sum() > 0:
                freq = counts[s] / counts[s].sum()
                np.testing.assert_allclose(freq, matrix[s], atol=0.03)

    def test_random_trace_uniform(self):
        t = tpu.random_pu_trace(torch.Generator().manual_seed(1), 9_000).numpy()
        assert t.min() == 0 and t.max() == 2
        np.testing.assert_allclose(np.bincount(t) / t.size, [1 / 3] * 3, atol=0.03)


class TestScene:
    def test_occupancy_to_powers_equals_jax(self):
        trace = np.array([0, 2, -1, 1, 3], np.int32)
        got = tscene.occupancy_to_powers(torch.from_numpy(trace), 3, power=0.05)
        want = jscene.occupancy_to_powers(jnp.asarray(trace), 3, power=0.05)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("taps", [129, 8])
    def test_convolve_same_alignment(self, rng, taps):
        x = rng.standard_normal((3, 300)).astype(np.float32)
        h = rng.standard_normal(taps).astype(np.float32)
        got = tscene._convolve_same(torch.from_numpy(x), torch.from_numpy(h)).numpy()
        want = np.stack([np.convolve(r, h, "same") for r in x])
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    def test_band_power_matches_jax_scene(self):
        """Each channel's mean power in its band, and the noise floor's, are
        within 10% of the JAX scene's."""
        cycles = 24
        trace = np.arange(cycles) % 3
        n = 5120
        t_iq = tscene.synthesize_scene(
            torch.Generator().manual_seed(0),
            tscene.occupancy_to_powers(torch.from_numpy(trace), 3, power=0.05),
            n,
            as_planes=True,
        ).numpy()
        j_iq = np.asarray(
            jscene.synthesize_scene(
                jax.random.key(0),
                jscene.occupancy_to_powers(jnp.asarray(trace), 3, power=0.05),
                n,
                as_planes=True,
            )
        )
        assert t_iq.shape == j_iq.shape == (cycles, n, 2) and t_iq.dtype == np.float32

        def band_power(planes):
            x = (planes[..., 0] + 1j * planes[..., 1]).reshape(cycles, 10, 512)
            p = (np.abs(np.fft.fft(x, axis=-1)) ** 2).mean(axis=1)  # (C, 512)
            bins = [np.r_[0:16, 496:511], np.r_[55:85], np.r_[189:222]]
            on = [p[trace == ch][:, bins[ch]].mean() for ch in range(3)]
            return np.array(on + [p[:, 300:310].mean()])

        np.testing.assert_allclose(band_power(t_iq), band_power(j_iq), rtol=0.10)

    def test_complex_output_equals_planes(self):
        powers = tscene.occupancy_to_powers(torch.tensor([0, 1]), 3, power=0.05)
        z = tscene.synthesize_scene(torch.Generator().manual_seed(5), powers, 1024)
        p = tscene.synthesize_scene(
            torch.Generator().manual_seed(5), powers, 1024, as_planes=True
        )
        assert z.dtype == torch.complex64
        np.testing.assert_array_equal(p[..., 0].numpy(), z.real.numpy())
        np.testing.assert_array_equal(p[..., 1].numpy(), z.imag.numpy())


class TestChannel:
    def test_mixers_and_gain_match_jax(self, rng):
        x = (rng.standard_normal((2, 256)) + 1j * rng.standard_normal((2, 256))).astype(
            np.complex64
        )
        off = np.array([1.5e6, -2e6], np.float32)
        got = tchannel.mix_to_offset(torch.from_numpy(x), torch.from_numpy(off), 13e6, t0=7)
        want = jchannel.mix_to_offset(jnp.asarray(x), jnp.asarray(off), 13e6, t0=7)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
        got = tchannel.apply_cfo(torch.from_numpy(x), 0.01, t0=3)
        want = jchannel.apply_cfo(jnp.asarray(x), 0.01, t0=3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(
            tchannel.soft_gain(-6.0).numpy(), np.asarray(jchannel.soft_gain(-6.0)), rtol=1e-6
        )

    def test_awgn_snr(self):
        x = torch.ones(200_000, dtype=torch.complex64)
        y = tchannel.awgn(torch.Generator().manual_seed(0), x, 10.0)
        noise = (y - x).abs().pow(2).mean().item()
        assert y.dtype == torch.complex64
        np.testing.assert_allclose(noise, 0.1, rtol=0.02)


class TestCaptures:
    def test_captures_cross_read(self, rng, tmp_path):
        planes = rng.standard_normal((1000, 2)).astype(np.float32)
        for writer, reader, name in (
            (tiq.IQWriter, jiq.IQReader, "port.iq"),
            (jiq.IQWriter, tiq.IQReader, "jax.iq"),
        ):
            with writer(tmp_path / name, 13e6, 833e6) as w:
                w.write(planes[:600])
                w.write(planes[600:, 0] + 1j * planes[600:, 1])
            r = reader(tmp_path / name)
            assert r.num_samples == 1000 and r.sample_rate_hz == 13e6 and r.center_hz == 833e6
            np.testing.assert_array_equal(np.concatenate(list(r.blocks(250))), planes)
        assert (tmp_path / "port.iq").read_bytes() == (tmp_path / "jax.iq").read_bytes()
        assert (tmp_path / "port.iq.json").read_text() == (tmp_path / "jax.iq.json").read_text()

    def test_cursor_resumes(self, rng, tmp_path):
        planes = rng.standard_normal((100, 2)).astype(np.float32)
        with tiq.IQWriter(tmp_path / "c.iq", 13e6, 833e6) as w:
            w.write(planes)
        r = tiq.IQReader(tmp_path / "c.iq")
        r.read(40)
        r.cursor.save(tmp_path / "cur.json")
        r2 = tiq.IQReader(tmp_path / "c.iq", tiq.StreamCursor.load(tmp_path / "cur.json"))
        np.testing.assert_array_equal(r2.read(60), planes[40:])
        assert r2.read(1) is None


class TestSenseCLI:
    @pytest.fixture
    def capture(self, tmp_path):
        """2 x 16 cycles of a PU scene that hops every cycle."""
        trace = np.arange(32) % 3
        iq = tscene.synthesize_scene(
            torch.Generator().manual_seed(11),
            tscene.occupancy_to_powers(torch.from_numpy(trace), 3, power=0.05),
            5120,
            as_planes=True,
        )
        cap = tmp_path / "cap.iq"
        with tiq.IQWriter(cap, 13e6, 833e6) as w:
            w.write(iq.numpy().reshape(-1, 2))
        return trace, cap

    def test_port_cli_matches_jax_cli(self, capture, tmp_path):
        trace, cap = capture
        assert jax_cli(["sense", str(cap), "-o", str(tmp_path / "jax.npz"), "-c", "16"]) == 0
        assert (
            port_cli(
                ["sense", str(cap), "-o", str(tmp_path / "port.npz"), "-c", "16", "--device", "cpu"]
            )
            == 0
        )
        with np.load(tmp_path / "jax.npz") as j, np.load(tmp_path / "port.npz") as t:
            assert t["decision"].shape == (32,)
            np.testing.assert_array_equal(t["decision"], j["decision"])
            np.testing.assert_array_equal(t["decision"], trace + 1)
            np.testing.assert_allclose(t["features"], j["features"], rtol=1e-4)
            np.testing.assert_array_equal(t["tx_freq"], j["tx_freq"])
            assert float(t["sample_rate_hz"]) == 13e6 and float(t["center_hz"]) == 833e6

    def test_cursor_and_weights(self, capture, tmp_path):
        _, cap = capture
        ckpt, cursor = tmp_path / "mlp.npz", tmp_path / "cursor.json"
        save_mlp(ckpt, reference_weights())
        args = ["sense", str(cap), "-c", "16", "--device", "cpu", "--cursor", str(cursor)]
        assert port_cli(args + ["-w", str(ckpt)]) == 0
        assert port_cli(args) == 1  # cursor at the end: nothing left to sense
