"""Port parity for the whole sense->classify slice.

The port's ``sense_classify_trace`` against the JAX package's (on the CPU)
and against the scalar oracle tests/golden_reference.py, on the same numpy
scene.  Bounds are those of tests/tpu_gates.py::gate_fused_sense: features
rtol 5e-3 and outputs atol 2e-3 against the oracle, decisions equal.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cognitive_radio_network_tpu.io.checkpoint import load_mlp_with_meta as jax_load_mlp
from cognitive_radio_network_tpu.io.checkpoint import save_mlp as jax_save_mlp
from cognitive_radio_network_tpu.models import SenseConfig as JaxSenseConfig
from cognitive_radio_network_tpu.models import sense_classify_trace as jax_trace
from cognitive_radio_network_tpu.signal.mlp import MLPParams
from cognitive_radio_network_tpu.signal.mlp import reference_weights as jax_weights
from cognitive_radio_network_tpu_torch.env.scene import occupancy_to_powers, synthesize_scene
from cognitive_radio_network_tpu_torch.io.checkpoint import load_mlp_with_meta, save_mlp
from cognitive_radio_network_tpu_torch.models import (
    SenseConfig,
    make_sense_fn,
    sense_classify,
    sense_classify_trace,
)
from cognitive_radio_network_tpu_torch.models.sense import _tx_freq_trace
from cognitive_radio_network_tpu_torch.signal.mlp import params_from_numpy, reference_weights

import golden_reference as gold

C = 16


@pytest.fixture
def scene(rng):
    """(trace (C,), planes (C, 10, 512, 2) float32): a PU scene with some
    all-quiet cycles, as numpy, the input both packages get."""
    trace = rng.integers(-1, 3, size=C)
    gen = torch.Generator().manual_seed(int(rng.integers(1 << 31)))
    planes = synthesize_scene(
        gen, occupancy_to_powers(torch.from_numpy(trace), 3, power=0.05), 5120, as_planes=True
    )
    return trace, planes.numpy().reshape(C, 10, 512, 2)


def _forms(planes):
    x = planes[..., 0] + 1j * planes[..., 1]
    return {
        "planar": (
            torch.from_numpy(np.ascontiguousarray(planes[..., 0]).reshape(-1, 512)),
            torch.from_numpy(np.ascontiguousarray(planes[..., 1]).reshape(-1, 512)),
        ),
        "complex": torch.from_numpy(x.astype(np.complex64)),
        "planes": torch.from_numpy(planes),
    }


@pytest.mark.parametrize("form", ["planar", "complex", "planes"])
def test_slice_matches_jax_and_golden(scene, form):
    trace, planes = scene
    jres, jfreq = jax_trace(jnp.asarray(planes), jax_weights(), 833e6, JaxSenseConfig())
    res, freq = sense_classify_trace(_forms(planes)[form], reference_weights(), 833e6)
    feats_ref, outs_ref, decs_ref = gold.sense_classify_reference(
        planes[..., 0] + 1j * planes[..., 1]
    )
    got = {k: v.numpy() for k, v in res.items()}
    assert got["avg_spectrum"].shape == (C, 512) and got["decision"].dtype == np.int32
    np.testing.assert_allclose(got["features"], feats_ref, rtol=5e-3)
    np.testing.assert_allclose(got["outputs"], outs_ref, atol=2e-3)
    np.testing.assert_array_equal(got["decision"], decs_ref)
    np.testing.assert_array_equal(got["decision"], np.asarray(jres["decision"]))
    np.testing.assert_allclose(got["features"], np.asarray(jres["features"]), rtol=1e-4)
    np.testing.assert_allclose(
        got["avg_spectrum"], np.asarray(jres["avg_spectrum"]), rtol=1e-4, atol=1e-5
    )
    assert freq.dtype == torch.float32
    np.testing.assert_array_equal(freq.numpy(), np.asarray(jfreq))
    # the scene's PU channel is what the classifier finds on occupied cycles
    busy = trace >= 0
    np.testing.assert_array_equal(got["decision"][busy], trace[busy] + 1)


def test_kernel_wrapper_path_on_cpu_equals_plain_graph(scene):
    """use_fused_kernel=True sends CPU tensors through the kernel wrapper,
    whose plain version must agree with the plain graph."""
    _, planes = scene
    x = _forms(planes)["planar"]
    fused = sense_classify(x, reference_weights(), SenseConfig(use_fused_kernel=True))
    plain = sense_classify(x, reference_weights(), SenseConfig(use_fused_kernel=False))
    np.testing.assert_array_equal(fused["decision"].numpy(), plain["decision"].numpy())
    np.testing.assert_allclose(fused["features"].numpy(), plain["features"].numpy(), rtol=1e-5)


def _perturbed_weights(rng):
    return MLPParams(
        *(np.asarray(v) * rng.uniform(0.5, 1.5, size=np.shape(v)).astype(np.float32)
          for v in jax_weights())
    )


def test_log1p_checkpoint_from_jax(scene, rng, tmp_path):
    _, planes = scene
    params = _perturbed_weights(rng)
    path = tmp_path / "jax_mlp.npz"
    jax_save_mlp(path, params, feature_transform="log1p")
    mlp, meta = load_mlp_with_meta(path)
    assert meta["feature_transform"] == "log1p"
    for name, want in zip(("w1", "b1", "w2", "b2"), params):
        np.testing.assert_array_equal(getattr(mlp, name).detach().numpy(), want)
    jcfg = dataclasses.replace(JaxSenseConfig(), feature_transform="log1p")
    cfg = dataclasses.replace(SenseConfig(), feature_transform="log1p")
    jres, _ = jax_trace(jnp.asarray(planes), params, 833e6, jcfg)
    res = make_sense_fn(cfg)(_forms(planes)["planar"], mlp)
    np.testing.assert_allclose(res["outputs"].numpy(), np.asarray(jres["outputs"]), atol=1e-5)
    np.testing.assert_array_equal(res["decision"].numpy(), np.asarray(jres["decision"]))


def test_checkpoint_from_port_loads_in_jax(rng, tmp_path):
    mlp = params_from_numpy(*_perturbed_weights(rng))
    path = tmp_path / "port_mlp.npz"
    save_mlp(path, mlp, feature_transform="log1p")
    params, meta = jax_load_mlp(path)
    assert meta["feature_transform"] == "log1p"
    for name, got in zip(("w1", "b1", "w2", "b2"), params):
        np.testing.assert_array_equal(np.asarray(got), getattr(mlp, name).detach().numpy())
    _, meta = load_mlp_with_meta(path)
    assert meta == {"feature_transform": "log1p"}


def test_tx_trace_matches_sequential_policy(rng):
    """The vectorized trace equals the reference's cycle-by-cycle policy,
    including leading all-busy cycles that keep the initial frequency."""
    dec = rng.integers(0, 4, size=300).astype(np.int32)
    dec[:5] = 0
    want, f = [], 838e6
    for d in dec:
        f = gold.next_freq_reference(int(d), f)
        want.append(f)
    got = _tx_freq_trace(torch.from_numpy(dec), 838e6, SenseConfig().channels_hz)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))
    empty = _tx_freq_trace(torch.zeros(0, dtype=torch.int32), 833e6, SenseConfig().channels_hz)
    assert empty.shape == (0,)


def test_make_sense_fn_is_cached_per_config():
    cfg = SenseConfig()
    assert make_sense_fn(cfg) is make_sense_fn(SenseConfig())
    assert make_sense_fn(cfg, with_trace=True) is not make_sense_fn(cfg)
    assert cfg.samples_per_cycle == 5120 and cfg.precision == "high"
    assert dataclasses.asdict(cfg).keys() == dataclasses.asdict(JaxSenseConfig()).keys()
