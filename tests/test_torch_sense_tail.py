"""Port parity for the sense chain's tail: ``fused_sense_classify`` and the
fused path of ``sense_classify`` / ``sense_classify_trace``, on the CPU.

The CPU runs the classify kernel's plain version (the kernel itself is held to
it on the card in tests/test_torch_cuda_kernels.py).  Both packages get the
same numpy scene and the same numpy weights: the reference weights, a
checkpoint the JAX package saved (log1p features), and seeded weights of
another hidden width.  Decisions and the retune trace must be equal; features
within rtol 1e-4 of the JAX package's (two float32 FFTs factored alike whose
sums run in another order); outputs within atol 1e-5 (those features through
the float32 MLP, whose sigmoids flatten the difference).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cognitive_radio_network_tpu.io.checkpoint import save_mlp as jax_save_mlp
from cognitive_radio_network_tpu.models import SenseConfig as JaxSenseConfig
from cognitive_radio_network_tpu.models import sense_classify_trace as jax_trace
from cognitive_radio_network_tpu.signal.mlp import MLPParams
from cognitive_radio_network_tpu.signal.mlp import reference_weights as jax_weights
from cognitive_radio_network_tpu_torch.env.scene import occupancy_to_powers, synthesize_scene
from cognitive_radio_network_tpu_torch.io.checkpoint import load_mlp_with_meta
from cognitive_radio_network_tpu_torch.models import (
    SenseConfig,
    make_sense_fn,
    sense_classify,
    sense_classify_trace,
)
from cognitive_radio_network_tpu_torch.ops.fused_sense_ct import (
    MAX_HIDDEN,
    fused_sense_classify,
    fused_sense_classify_plain,
    fused_sense_ct,
    sense_trace,
    sense_trace_plain,
)
from cognitive_radio_network_tpu_torch.signal.mlp import params_from_numpy


def _scene(c, seed):
    """(C, 10, 512, 2) float32 planes of a PU scene with some quiet cycles."""
    rng = np.random.default_rng(seed)
    trace = rng.integers(-1, 3, size=c)
    gen = torch.Generator().manual_seed(seed)
    powers = occupancy_to_powers(torch.from_numpy(trace), 3, power=0.05)
    return synthesize_scene(gen, powers, 5120, as_planes=True).numpy().reshape(c, 10, 512, 2)


def _detector(h, seed):
    """Seeded float32 weights of h >= 3 hidden units that find the PU on log1p
    features: unit j < 3 weighs channel j against the noise floor and drives
    output j; the rest, and every other weight, are seeded noise."""
    rng = np.random.default_rng(seed)
    w1, b1 = rng.uniform(-0.3, 0.3, (4, h)), rng.uniform(-1, 1, h)
    w2, b2 = rng.uniform(-0.5, 0.5, (h, 3)), np.full(3, -4.0)
    for j in range(3):
        w1[0, j] -= 1.0
        w1[1 + j, j] += 1.0
        b1[j] = -5.0
        w2[j, j] += 8.0
    return tuple(v.astype(np.float32) for v in (w1, b1, w2, b2))


def _weights(kind, tmp_path):
    """numpy (w1, b1, w2, b2) and the port's OccupancyMLP holding them."""
    if kind == "reference":
        w = tuple(np.array(v) for v in jax_weights())
        return w, params_from_numpy(*w)
    if kind == "checkpoint":  # 4-5-3, saved by the JAX package, loaded by the port
        w = _detector(5, seed=7)
        path = tmp_path / "jax_mlp.npz"
        jax_save_mlp(path, MLPParams(*w), feature_transform="log1p")
        mlp, meta = load_mlp_with_meta(path)
        assert meta["feature_transform"] == "log1p"
        return w, mlp
    w = _detector(int(kind[1:]), seed=11)  # "h7": 7 hidden units
    return w, params_from_numpy(*w)


# (C, feature_transform, weights, threshold, tx0 as): the reference weights on
# raw features; a JAX checkpoint and seeded weights of another width on log1p
# features; thresholds 0.8 and others; the start as a float or a 0-d tensor
CASES = [
    (16, "none", "reference", 0.8, "float"),
    (1, "none", "reference", 0.8, "tensor"),
    (16, "log1p", "checkpoint", 0.8, "tensor"),
    (1, "log1p", "checkpoint", 0.5, "float"),
    (16, "log1p", "h7", 0.5, "float"),
    (1, "log1p", "h7", 0.8, "tensor"),
    (16, "none", "h7", 0.3, "tensor"),
]


@pytest.mark.parametrize("c,transform,weights,threshold,tx0_as", CASES)
def test_tail_matches_jax(c, transform, weights, threshold, tx0_as, tmp_path):
    planes = _scene(c, seed=c + len(weights))
    w, mlp = _weights(weights, tmp_path)
    jcfg = dataclasses.replace(JaxSenseConfig(), feature_transform=transform, threshold=threshold)
    jres, jfreq = jax_trace(jnp.asarray(planes), MLPParams(*w), 835e6, jcfg)
    want = {k: np.asarray(v) for k, v in jres.items()}
    tx0 = 835e6 if tx0_as == "float" else torch.tensor(835e6, dtype=torch.float64)
    xr, xi = (torch.from_numpy(np.ascontiguousarray(planes[..., i]).reshape(-1, 512))
              for i in (0, 1))
    cfg = SenseConfig(use_fused_kernel=True, feature_transform=transform, threshold=threshold)

    before = fused_sense_ct.launches, sense_trace.launches
    plain = fused_sense_classify_plain(xr, xi, *(torch.from_numpy(v) for v in w),
                                       log1p=transform == "log1p", threshold=threshold, tx0=tx0)
    fused = sense_classify_trace((xr, xi), mlp, tx0, cfg)
    alone = sense_classify((xr, xi), mlp, cfg)
    assert (fused_sense_ct.launches, sense_trace.launches) == before  # the CPU launches nothing
    for avg, feats, outs, dec, freq in (plain, (*fused[0].values(), fused[1]),
                                        (*alone.values(), fused[1])):
        assert dec.dtype == torch.int32 and freq.dtype == torch.float32
        assert outs.shape == (c, 3) and avg.shape == (c, 512)
        np.testing.assert_array_equal(dec.numpy(), want["decision"])
        np.testing.assert_array_equal(freq.numpy(), np.asarray(jfreq))
        np.testing.assert_allclose(feats.numpy(), want["features"], rtol=1e-4)
        np.testing.assert_allclose(outs.numpy(), want["outputs"], rtol=0.0, atol=1e-5)
        np.testing.assert_allclose(avg.numpy(), want["avg_spectrum"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("transform", ["none", "log1p"])
def test_fused_path_equals_plain_graph(transform, tmp_path):
    """use_fused_kernel=True on the CPU runs the classify kernel's plain version;
    use_fused_kernel=False runs the plain graph: the same decisions, trace and
    features, through the same MLP."""
    planes = torch.from_numpy(_scene(16, seed=3))
    _, mlp = _weights("checkpoint" if transform == "log1p" else "reference", tmp_path)
    fused = make_sense_fn(SenseConfig(use_fused_kernel=True, feature_transform=transform),
                          with_trace=True, device="cpu")(planes, mlp, 833e6)
    graph = make_sense_fn(SenseConfig(use_fused_kernel=False, feature_transform=transform),
                          with_trace=True, device="cpu")(planes, mlp, 833e6)
    assert fused[0].keys() == graph[0].keys()
    np.testing.assert_array_equal(fused[0]["decision"].numpy(), graph[0]["decision"].numpy())
    np.testing.assert_array_equal(fused[1].numpy(), graph[1].numpy())
    np.testing.assert_allclose(fused[0]["features"].numpy(), graph[0]["features"].numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(fused[0]["outputs"].numpy(), graph[0]["outputs"].numpy(),
                               rtol=0.0, atol=1e-6)


def _bad_weights():
    ok = {"w1": torch.zeros(4, 5), "b1": torch.zeros(5), "w2": torch.zeros(5, 3),
          "b2": torch.zeros(3)}
    h = MAX_HIDDEN + 1
    return {
        "w1 of 3 inputs": (ValueError, {**ok, "w1": torch.zeros(3, 5)}),
        "w1 1-d": (ValueError, {**ok, "w1": torch.zeros(20)}),
        "b1 too short": (ValueError, {**ok, "b1": torch.zeros(4)}),
        "w2 of 2 outputs": (ValueError, {**ok, "w2": torch.zeros(5, 2)}),
        "b2 of 4": (ValueError, {**ok, "b2": torch.zeros(4)}),
        "no hidden unit": (ValueError, {"w1": torch.zeros(4, 0), "b1": torch.zeros(0),
                                        "w2": torch.zeros(0, 3), "b2": torch.zeros(3)}),
        f"H={h}": (ValueError, {"w1": torch.zeros(4, h), "b1": torch.zeros(h),
                                "w2": torch.zeros(h, 3), "b2": torch.zeros(3)}),
        "float64 w1": (TypeError, {**ok, "w1": torch.zeros(4, 5, dtype=torch.float64)}),
        "bfloat16 b2": (TypeError, {**ok, "b2": torch.zeros(3, dtype=torch.bfloat16)}),
    }


@pytest.mark.parametrize("case", list(_bad_weights()))
def test_rejects_weights_outside_the_contract(case):
    """The wrapper checks the weights on the CPU as on the card, and names the shapes."""
    err, w = _bad_weights()[case]
    xr = xi = torch.zeros(10, 512)
    match = "float32 weights" if err is TypeError else r"w1 \(4, H\).*got w1"
    with pytest.raises(err, match=match):
        fused_sense_classify(xr, xi, w["w1"], w["b1"], w["w2"], w["b2"])


@pytest.mark.parametrize("tx0", [833e6, np.float32(838e6), torch.tensor(835e6),
                                 torch.tensor(838e6, dtype=torch.float64)])
def test_trace_on_the_cpu_is_the_plain_scan(tx0):
    """sense_trace on CPU tensors is its plain version and equals the
    reference's cycle-by-cycle policy, whatever form tx0 takes."""
    rng = np.random.default_rng(11)
    dec = rng.integers(0, 4, size=257).astype(np.int32)
    dec[:9] = 0
    want, f = [], np.float32(float(tx0))
    for d in dec:
        f = {1: np.float32(835e6), 2: np.float32(833e6), 3: np.float32(835e6)}.get(int(d), f)
        want.append(f)
    before = sense_trace.launches
    got = sense_trace(torch.from_numpy(dec), tx0)
    assert sense_trace.launches == before
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))
    np.testing.assert_array_equal(sense_trace_plain(torch.from_numpy(dec), tx0).numpy(),
                                  got.numpy())


def test_empty_batch():
    w = tuple(torch.from_numpy(np.array(v)) for v in jax_weights())
    out = fused_sense_classify(torch.zeros(0, 512), torch.zeros(0, 512), *w, tx0=833e6)
    assert [tuple(v.shape) for v in out] == [(0, 512), (0, 4), (0, 3), (0,), (0,)]
