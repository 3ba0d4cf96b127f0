"""Port parity: the one-device wideband detector (PyTorch) vs the JAX package.

The same numpy arrays go through both; no seed is shared between the
frameworks.  The JAX Pallas kernel runs in interpret mode on the CPU, as
tests/test_ops_pallas.py runs it; ``wideband_sense`` and ``make_sharded_apply``
of the JAX package run on a one-device mesh.  On CPU tensors the port's
wrapper runs the kernel's plain version.

Tolerances: energies rtol 1e-5, atol 1e-7 at "highest" (both sides float32,
different summation orders; the bound of tests/test_ops_pallas.py:195) and
rtol 2e-3, atol 1e-5 against the JAX kernel's bf16_3x rung and against the
float64 oracles (tests/tpu_gates.py).  ``occupied`` is compared exactly only
on the tone scene, whose margin is orders of magnitude.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

import tpu_gates
from cognitive_radio_network_tpu.models.distributed import (
    make_sharded_apply as jax_make_sharded_apply,
    wideband_features as jax_wideband_features,
)
from cognitive_radio_network_tpu.ops.fused_wideband import (
    wideband_energy_fused as jax_wideband_energy_fused,
)
from cognitive_radio_network_tpu.parallel import MeshSpec, make_mesh
from cognitive_radio_network_tpu.parallel import wideband as jwb
from cognitive_radio_network_tpu.signal.mlp import init_mlp
from cognitive_radio_network_tpu_torch.models.distributed import (
    make_sharded_apply,
    wideband_features,
)
from cognitive_radio_network_tpu_torch.ops.fused_wideband import (
    _fir_rows,
    wideband_energy_fused,
    wideband_energy_fused_plain,
    wideband_energy_fused_planes,
    wideband_energy_fused_planes_plain,
)
from cognitive_radio_network_tpu_torch.parallel.wideband import (
    WidebandConfig,
    make_wideband_fn,
    wideband_energy_packed,
    wideband_sense,
)
from cognitive_radio_network_tpu_torch.signal.mlp import params_from_numpy

CFG = WidebandConfig()
JCFG = jwb.WidebandConfig()
TAPS = CFG.taps()


def _planar(rng, t, m=64):
    return (
        rng.standard_normal(t * m).astype(np.float32),
        rng.standard_normal(t * m).astype(np.float32),
    )


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _tone_scene(rng, t, m, active):
    """Noise at amplitude 1e-3 plus unit tones at the centres of ``active``."""
    n = t * m
    x = 0.001 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for k in active:
        x = x + np.exp(2j * np.pi * (k / m) * np.arange(n))
    return np.stack([x.real, x.imag], axis=-1).astype(np.float32)


def _mesh_time_data():
    """One device under both axis names, so the JAX package takes its
    batched packed path (``batch_axis='data'``)."""
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("time", "data"))


def test_config_defaults_and_taps_equal():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JCFG)
    np.testing.assert_array_equal(TAPS, JCFG.taps())
    assert TAPS.shape == (8, 64)


def test_fir_rows_matches_jax(rng):
    v_in = rng.standard_normal((2, 40, 128)).astype(np.float32)
    hist = rng.standard_normal((2, 7, 128)).astype(np.float32)
    for h in (None, hist):
        want = jwb._fir_rows(
            jnp.asarray(v_in), jnp.asarray(TAPS), None if h is None else jnp.asarray(h)
        )
        got = _fir_rows(
            torch.from_numpy(v_in), torch.from_numpy(TAPS), None if h is None else torch.from_numpy(h)
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("t", [256, 1280])
def test_packed_matches_jax(rng, t, precision):
    xr, xi = _planar(rng, t)
    want = jwb.wideband_energy_packed(
        jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(TAPS), JCFG, precision=precision
    )
    got = wideband_energy_packed(*_t(xr, xi), TAPS, CFG, precision=precision)
    assert got.shape == (t // 128, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


def test_packed_other_width_matches_jax(rng):
    cfg = WidebandConfig(num_channels=16, taps_per_channel=4, block_len=32)
    jcfg = jwb.WidebandConfig(num_channels=16, taps_per_channel=4, block_len=32)
    xr, xi = _planar(rng, 96, 16)
    want = jwb.wideband_energy_packed(
        jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(jcfg.taps()), jcfg, precision="highest"
    )
    got = wideband_energy_packed(*_t(xr, xi), cfg.taps(), cfg, precision="highest")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


def test_packed_batched_equals_rows(rng):
    """Leading batch dimensions: each row is a stream of its own."""
    rows = [_planar(rng, 256) for _ in range(3)]
    xr = np.stack([r[0] for r in rows])
    xi = np.stack([r[1] for r in rows])
    got = wideband_energy_packed(*_t(xr, xi), TAPS, CFG, precision="highest")
    assert got.shape == (3, 2, 64)
    for b, (r, i) in enumerate(rows):
        one = wideband_energy_packed(*_t(r, i), TAPS, CFG, precision="highest")
        np.testing.assert_allclose(got[b].numpy(), one.numpy(), rtol=1e-6, atol=1e-9)


def test_packed_rejects_partial_cycle():
    x = torch.zeros(100 * 64)
    with pytest.raises(ValueError, match="multiple of block_len"):
        wideband_energy_packed(x, x, TAPS, CFG)


@pytest.mark.parametrize(
    "t,tile_q,precision,rtol,atol",
    [
        (1024, 512, "highest", 1e-5, 1e-7),  # one tile
        (4096, 512, "highest", 1e-5, 1e-7),  # four tiles: the halo between tiles
        (512, 256, "highest", 1e-5, 1e-7),
        (1024, 512, "high", 2e-3, 1e-5),  # the JAX kernel's bf16_3x rung
    ],
)
def test_fused_plain_matches_jax_kernel(rng, t, tile_q, precision, rtol, atol):
    xr, xi = _planar(rng, t)
    want = jax_wideband_energy_fused(
        jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(TAPS), JCFG,
        precision=precision, tile_q=tile_q, interpret=True,
    )
    got = wideband_energy_fused_plain(*_t(xr, xi), TAPS, CFG, precision=precision)
    assert got.shape == (t // 128, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


def test_fused_plain_with_history_matches_jax_kernel(rng):
    t = 1024
    xr, xi = _planar(rng, t)
    hr = rng.standard_normal((4, 128)).astype(np.float32)
    hi = rng.standard_normal((4, 128)).astype(np.float32)
    want = jax_wideband_energy_fused(
        jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(TAPS), JCFG, precision="highest",
        tile_q=512, interpret=True, initial_history=(jnp.asarray(hr), jnp.asarray(hi)),
    )
    got = wideband_energy_fused_plain(
        *_t(xr, xi), TAPS, CFG, precision="highest", initial_history=_t(hr, hi)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    rest = wideband_energy_fused_plain(*_t(xr, xi), TAPS, CFG, precision="highest")
    assert not np.allclose(got[0].numpy(), rest[0].numpy(), rtol=1e-3)  # the history counts
    np.testing.assert_array_equal(got[1:].numpy(), rest[1:].numpy())  # and only in cycle 0


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_fused_plain_matches_float64_oracle(rng, precision):
    xr, xi = _planar(rng, 512)
    want = tpu_gates.wideband_energy_numpy(xr, xi, TAPS, CFG)
    got = wideband_energy_fused_plain(*_t(xr, xi), TAPS, CFG, precision=precision)
    rtol = 2e-2 if precision == "default" else 2e-3  # one bf16 pass keeps ~3 digits
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=1e-5)


def test_fused_plain_with_history_matches_float64_oracle(rng):
    xr, xi = _planar(rng, 512)
    hr = rng.standard_normal((4, 128)).astype(np.float32)
    hi = rng.standard_normal((4, 128)).astype(np.float32)
    want = tpu_gates.wideband_energy_numpy_with_history(xr, xi, hr, hi, TAPS, CFG)
    got = wideband_energy_fused_plain(
        *_t(xr, xi), TAPS, CFG, precision="highest", initial_history=_t(hr, hi)
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=1e-5)


def test_fused_plain_split_stream_equals_whole(rng):
    """The first half's last 4 pair rows as the second half's history give
    the whole stream's energies: the FIR's tap order and the history layout."""
    t = 1024
    xr, xi = _planar(rng, t)
    whole = wideband_energy_fused_plain(*_t(xr, xi), TAPS, CFG, precision="highest")
    h = (t // 2) * 64
    first = wideband_energy_fused_plain(*_t(xr[:h], xi[:h]), TAPS, CFG, precision="highest")
    hist = _t(xr[h - 512 : h].reshape(4, 128), xi[h - 512 : h].reshape(4, 128))
    second = wideband_energy_fused_plain(
        *_t(xr[h:], xi[h:]), TAPS, CFG, precision="highest", initial_history=hist
    )
    np.testing.assert_allclose(
        torch.cat([first, second]).numpy(), whole.numpy(), rtol=1e-6, atol=1e-9
    )


def test_fused_wrapper_on_cpu_runs_plain_version(rng):
    """A CPU tensor takes the plain version, bit for bit, and launches nothing."""
    xr, xi = _t(*_planar(rng, 256))
    before = wideband_energy_fused.launches
    got = wideband_energy_fused(xr, xi, TAPS, CFG)
    assert wideband_energy_fused.launches == before
    assert torch.equal(got, wideband_energy_fused_plain(xr, xi, TAPS, CFG))


def test_fused_any_whole_number_of_cycles(rng):
    """T need only be a multiple of block_len: 10 cycles, not a power of two,
    which the TPU kernel's tiling refuses."""
    xr, xi = _planar(rng, 1280)
    got = wideband_energy_fused(*_t(xr, xi), TAPS, CFG, precision="highest")
    assert got.shape == (10, 64)
    want = tpu_gates.wideband_energy_numpy(xr, xi, TAPS, CFG)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=1e-5)
    empty = wideband_energy_fused(torch.zeros(0), torch.zeros(0), TAPS, CFG)
    assert empty.shape == (0, 64)


def _strided(shape, pad):
    """Zeros of ``shape`` whose streams (dimension 0) lie ``pad`` floats
    further apart than their length: a stride that is not whole rows."""
    n = shape[1] * (shape[2] if len(shape) > 2 else 1)
    flat = torch.zeros(shape[0], n + pad)[:, :n]
    return flat.reshape(shape) if len(shape) == 2 else flat.view(shape[0], shape[1], shape[2])


# (cfg, wide samples per stream or a form and shape, history shape, match); the
# first five keep their first ids
_REJECTS = [
    pytest.param(WidebandConfig(num_channels=16), 128, None, "M=64, P=8",
                 id="cfg0-128-None-M=64, P=8"),
    pytest.param(WidebandConfig(taps_per_channel=4), 128, None, "M=64, P=8",
                 id="cfg1-128-None-M=64, P=8"),
    pytest.param(WidebandConfig(block_len=127), 127, None, "even", id="cfg2-127-None-even"),
    pytest.param(CFG, 1000, None, "whole sense cycles", id="cfg3-1000-None-whole sense cycles"),
    pytest.param(CFG, 256, (8, 64), r"initial_history rows must be \(4, 128\)",
                 id=r"cfg4-256-hist_shape4-initial_history rows must be \(4, 128\)"),
    # a history that does not match the batch
    pytest.param(CFG, ("planar", (2, 256 * 64)), (3, 4, 128), "leading dimensions",
                 id="history-batch-mismatch-planar"),
    pytest.param(CFG, ("planes", (2, 256 * 64, 2)), (3, 4, 128), "leading dimensions",
                 id="history-batch-mismatch-planes"),
    # interleaved planes whose last dimension is not [re, im]
    pytest.param(CFG, ("planes", (256 * 64, 3)), None, "interleaved planes", id="last-dim-3"),
    pytest.param(CFG, ("planes", (2, 256 * 64)), None, "interleaved planes", id="last-dim-missing"),
    # streams at a stride that is not a whole number of rows
    pytest.param(CFG, ("planar-strided", (2, 256 * 64)), None, "whole number of rows",
                 id="stride-half-row-planar"),
    pytest.param(CFG, ("planes-strided", (2, 256 * 64, 2)), None, "whole number of rows",
                 id="stride-half-row-planes"),
]


@pytest.mark.parametrize("fn", [wideband_energy_fused, wideband_energy_fused_plain])
@pytest.mark.parametrize("cfg,t,hist_shape,match", _REJECTS)
def test_fused_rejects(fn, cfg, t, hist_shape, match):
    """Each wrapper and its plain version refuse what the kernel does not
    take; a case with a form runs the wrapper of that form (the planar pair,
    or ``wideband_energy_fused_planes`` and its plain version)."""
    taps = np.zeros((cfg.taps_per_channel, cfg.num_channels), np.float32)
    hist = None if hist_shape is None else (torch.zeros(hist_shape), torch.zeros(hist_shape))
    form, shape = ("planar", (t * cfg.num_channels,)) if isinstance(t, int) else t
    x = _strided(shape, 32) if form.endswith("strided") else torch.zeros(shape)
    with pytest.raises(ValueError, match=match):
        if form.startswith("planar"):
            fn(x, x, taps, cfg, initial_history=hist)
        else:
            planes_fn = {wideband_energy_fused: wideband_energy_fused_planes,
                         wideband_energy_fused_plain: wideband_energy_fused_planes_plain}[fn]
            planes_fn(x, taps, cfg, initial_history=hist)


def test_fused_rejects_unknown_precision():
    x = torch.zeros(128 * 64)
    with pytest.raises(ValueError, match="precision"):
        wideband_energy_fused(x, x, TAPS, CFG, precision="tf32")


@pytest.mark.parametrize("form", ["planes", "planar"])
@pytest.mark.parametrize("use_fused", [None, True, False])
def test_wideband_sense_matches_jax(rng, form, use_fused):
    t = 1024
    planes = rng.standard_normal((t * 64, 2)).astype(np.float32)
    planar = (np.ascontiguousarray(planes[:, 0]), np.ascontiguousarray(planes[:, 1]))
    mesh = make_mesh(MeshSpec())
    jcfg = jwb.WidebandConfig(precision="highest")
    cfg = WidebandConfig(precision="highest")
    j_in = jnp.asarray(planes) if form == "planes" else tuple(jnp.asarray(v) for v in planar)
    # the JAX package runs its packed path here (its kernel path is off on the CPU)
    want = jwb.wideband_sense(j_in, jnp.asarray(TAPS), mesh, jcfg, use_fused=False)
    t_in = torch.from_numpy(planes) if form == "planes" else _t(*planar)
    got = wideband_sense(t_in, torch.from_numpy(TAPS), cfg, use_fused=use_fused)
    assert got["energy"].shape == (8, 64) and got["noise"].shape == (8, 1)
    assert got["occupied"].shape == (8, 64) and got["occupied"].dtype == torch.bool
    np.testing.assert_allclose(got["energy"].numpy(), np.asarray(want["energy"]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got["noise"].numpy(), np.asarray(want["noise"]), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("use_fused", [None, True, False])
def test_wideband_sense_batched_matches_jax(rng, use_fused):
    """A batch of streams, through the fused wrapper in one call (None,
    True) or through the packed path (False), against the JAX package's
    batched packed path."""
    b, t = 3, 256
    planes = rng.standard_normal((b, t * 64, 2)).astype(np.float32)
    jcfg = jwb.WidebandConfig(precision="highest")
    cfg = WidebandConfig(precision="highest")
    want = jwb.wideband_sense(
        jnp.asarray(planes), jnp.asarray(TAPS), _mesh_time_data(), jcfg, batch_axis="data"
    )
    got = wideband_sense(torch.from_numpy(planes), TAPS, cfg, use_fused=use_fused)
    assert got["energy"].shape == (b, 2, 64) and got["noise"].shape == (b, 2, 1)
    np.testing.assert_allclose(got["energy"].numpy(), np.asarray(want["energy"]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got["noise"].numpy(), np.asarray(want["noise"]), rtol=1e-5, atol=1e-7)
    # each batch row equals the unbatched stream through the fused path's plain version
    one = wideband_sense(torch.from_numpy(planes[1]), TAPS, cfg)
    np.testing.assert_allclose(got["energy"][1].numpy(), one["energy"].numpy(), rtol=1e-6, atol=1e-9)


def test_wideband_sense_use_fused_on_other_shape_raises(rng):
    cfg = WidebandConfig(num_channels=16, taps_per_channel=8, block_len=64)
    planes = torch.zeros(64 * 16, 2)
    with pytest.raises(ValueError, match="fused path needs"):
        wideband_sense(planes, cfg.taps(), cfg, use_fused=True)
    res = wideband_sense(planes, cfg.taps(), cfg)  # auto: the packed path
    assert res["energy"].shape == (1, 16)
    with pytest.raises(ValueError, match="sense cycles"):
        wideband_sense(torch.zeros(100 * 16, 2), cfg.taps(), cfg)


@pytest.mark.parametrize("m,block_len,active", [(16, 64, [2, 7, 11]), (64, 128, [3, 17, 40, 63])])
def test_tone_scene_occupied_exact(rng, m, block_len, active):
    """Unit tones against 1e-3 noise: ``occupied`` is true on exactly the
    active channels in every cycle after the first (filter warm-up), and
    equal to the JAX package's."""
    cfg = WidebandConfig(num_channels=m, taps_per_channel=8, block_len=block_len)
    jcfg = jwb.WidebandConfig(num_channels=m, taps_per_channel=8, block_len=block_len)
    planes = _tone_scene(rng, 8 * block_len, m, active)
    fn = make_wideband_fn(cfg, device="cpu")
    got = fn(planes)  # numpy in: the function places it
    want = jwb.wideband_sense(jnp.asarray(planes), jnp.asarray(jcfg.taps()), make_mesh(MeshSpec()), jcfg)
    occ = got["occupied"].numpy()
    expect = np.zeros(m, bool)
    expect[active] = True
    assert (occ[1:] == expect).all()
    np.testing.assert_array_equal(occ, np.asarray(want["occupied"]))
    np.testing.assert_allclose(got["energy"].numpy(), np.asarray(want["energy"]), rtol=2e-3, atol=1e-7)


def test_wideband_features_matches_jax(rng):
    energy = rng.random((2, 5, 64)).astype(np.float32)
    noise = rng.random((2, 5, 1)).astype(np.float32)
    got = wideband_features(torch.from_numpy(energy), torch.from_numpy(noise))
    assert got.shape == (2, 5, 64, 4)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_wideband_features(jnp.asarray(energy), jnp.asarray(noise)))
    )
    assert got[0, 0, 0, 1] == energy[0, 0, 63] and got[0, 0, 63, 3] == energy[0, 0, 0]


@pytest.mark.parametrize("mesh_kind", ["time", "time+data"])
def test_sharded_apply_matches_jax(rng, mesh_kind):
    """The serving end as a whole, weights carried through params_from_numpy
    (a 4-5-1 network): occupancy probabilities within atol 1e-5."""
    b, t = 2, 512
    active = [5, 30]
    planes = np.stack([_tone_scene(rng, t, 64, active), _tone_scene(rng, t, 64, [12])])
    params = init_mlp(jax.random.key(3), n_in=4, n_hidden=5, n_out=1)
    # a non-zero bias too, so every field is seen to carry across
    params = params._replace(b1=jnp.asarray(rng.standard_normal(5), jnp.float32))
    mesh = make_mesh(MeshSpec()) if mesh_kind == "time" else _mesh_time_data()
    want = np.asarray(jax_make_sharded_apply(mesh, JCFG)(params, jnp.asarray(planes)))
    mlp = params_from_numpy(*(np.asarray(v) for v in params))
    assert mlp.w1.shape == (4, 5) and mlp.w2.shape == (5, 1)
    got = make_sharded_apply(CFG, device="cpu")(mlp, planes)
    assert got.shape == (b, t // 128, 64) and got.dtype == torch.float32
    assert bool(((got > 0) & (got < 1)).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
