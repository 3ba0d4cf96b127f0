"""Port parity: the mesh, the halo exchange and the sharded wideband functions
(PyTorch, gloo ranks on the CPU) vs the JAX package's sharded functions (8
virtual CPU devices) and the port's one-device forms.

Mirrors tests/test_parallel.py:79-334 (TestShardedChannelize, TestWideband,
TestPackedWidebandEnergy, TestBatchedWidebandFastPath), plus units of
``halo_exchange`` and ``make_mesh``.  One fleet of 8 ranks
(``parallel/launch.py::run_ranks``) runs every case's port side once per
module; the cases on 4 ranks use a mesh over the first 4.  The same numpy
arrays, drawn from seeds, go to both packages.  This file imports no JAX at
module level: the ranks import it, and they must not load JAX.

Tolerances are the reference's: sharded vs one-device energy rtol 1e-6,
atol 1e-9 at "highest"; channelized planes rtol 1e-4, atol 1e-5; the fast path
vs the channelizer rtol 2e-4, atol 1e-7; port vs JAX energies rtol 1e-5, atol
1e-7 at "highest" (both float32, different summation orders), rtol 2e-3, atol
1e-5 at "high" (the batched case), as tests/test_torch_wideband.py holds them.
"""

import numpy as np
import pytest
import torch

from cognitive_radio_network_tpu_torch.parallel import (
    MeshSpec,
    WidebandConfig,
    halo_exchange,
    make_mesh,
    make_wideband_fn,
    sharded_channelize,
    wideband_energy_packed,
    wideband_sense,
)
from cognitive_radio_network_tpu_torch.parallel.collectives import all_gather
from cognitive_radio_network_tpu_torch.parallel.launch import run_ranks
from cognitive_radio_network_tpu_torch.parallel.wideband import (
    sharded_wideband_energy_fused,
    sharded_wideband_energy_packed,
)
from cognitive_radio_network_tpu_torch.ops.fused_wideband import wideband_energy_fused
from cognitive_radio_network_tpu_torch.signal.channelizer import channelize_planes, polyphase_taps

WORLD = 8
ACTIVE = [2, 7, 11]  # tests/test_parallel.py:116


def _tone(freq_norm, n):
    return np.exp(2j * np.pi * freq_norm * np.arange(n)).astype(np.complex64)


def _planes(x):
    return np.stack([x.real, x.imag], axis=-1).astype(np.float32)


def _inputs() -> dict:
    """Every case's numpy input, each from its own seed."""
    rng = np.random.default_rng(1234)
    x = (rng.standard_normal(512 * 16) + 1j * rng.standard_normal(512 * 16)).astype(np.complex64)
    xb = (rng.standard_normal((2, 128 * 8)) + 1j * rng.standard_normal((2, 128 * 8))).astype(
        np.complex64
    )
    rng = np.random.default_rng(1235)
    tones = 0.001 * (rng.standard_normal(512 * 16) + 1j * rng.standard_normal(512 * 16)).astype(
        np.complex64
    )
    for k in ACTIVE:
        tones += _tone(k / 16, 512 * 16)
    rng = np.random.default_rng(1236)
    return {
        "channelize": _planes(x),
        "channelize_batch": _planes(xb),
        "tones": _planes(tones),
        "packed": rng.standard_normal((2, 8 * 128 * 64)).astype(np.float32),
        "fused": rng.standard_normal((2, 16 * 128 * 64)).astype(np.float32),
        "route": rng.standard_normal((8 * 128 * 64, 2)).astype(np.float32),
        "batch": rng.standard_normal((4, 64 * 16, 2)).astype(np.float32),
    }


def _gather(x, mesh, *names_dims):
    """The whole array from each rank's block: gathered along each (axis,
    dimension) in turn (booleans travel as uint8)."""
    flag = x.dtype == torch.bool
    x = x.to(torch.uint8) if flag else x
    for name, dim in names_dims:
        x = all_gather(x, mesh, name, dim)
    return x.numpy().astype(bool) if flag else x.numpy()


def _rank(inp: dict) -> dict:
    """Every case's port side on one rank: whole arrays in, each rank's
    blocks gathered back into whole arrays (on every rank)."""
    import torch.distributed as dist

    import cognitive_radio_network_tpu_torch.parallel.halo as halo_mod
    import cognitive_radio_network_tpu_torch.signal.channelizer as chan_mod

    rank = dist.get_rank()
    out = {}
    meshes = {
        "time8": MeshSpec(time=8),
        "time4_data2": MeshSpec(time=4, data=2),
        "time4_channel2": MeshSpec(time=4, channel=2),
        "time2_channel2_data2": MeshSpec(time=2, channel=2, data=2),
        "time4": MeshSpec(time=4),  # a mesh over the first 4 of the 8 ranks
        "one": MeshSpec(),
    }
    mesh = {k: make_mesh(spec, device="cpu") for k, spec in meshes.items()}
    out["meshes"] = {
        k: None if v is None else (v.mesh_dim_names, v.mesh.tolist(), v.get_coordinate())
        for k, v in mesh.items()
    }
    try:
        make_mesh(MeshSpec(time=16), device="cpu")
    except ValueError as e:
        out["too_big"] = str(e)

    # halo_exchange on (6,) blocks and along axis 1 of (2, 6) blocks
    m8 = mesh["time8"]
    block = torch.arange(6.0) + 100 * rank
    out["halo"] = _gather(halo_exchange(block, 2, m8, "time")[None], m8, ("time", 0))
    block2 = torch.stack([block, -block])
    out["halo_axis1"] = _gather(halo_exchange(block2, 3, m8, "time", axis=1)[None], m8, ("time", 0))
    try:
        halo_exchange(block, 7, m8, "time")
    except ValueError as e:
        out["halo_too_long"] = str(e)

    # TestShardedChannelize
    taps16 = polyphase_taps(16, 8)
    got = sharded_channelize(torch.from_numpy(inp["channelize"]), taps16, m8)
    out["channelize"] = _gather(got, m8, ("time", 0))
    m42d = mesh["time4_data2"]
    got = sharded_channelize(
        torch.from_numpy(inp["channelize_batch"]), polyphase_taps(8, 4), m42d, batch_axis="data"
    )
    out["channelize_batch"] = _gather(got, m42d, ("time", 1), ("data", 0))

    # TestWideband: the energy detector on a (time=4, channel=2) mesh
    m42c = mesh["time4_channel2"]
    cfg16 = WidebandConfig(num_channels=16, taps_per_channel=8, block_len=64)
    res = wideband_sense(inp["tones"], torch.from_numpy(cfg16.taps()), cfg16, mesh=m42c)
    out["tones"] = {
        k: _gather(res[k], m42c, ("channel", 1), ("time", 0)) for k in ("energy", "occupied")
    }
    out["tones"]["noise"] = _gather(res["noise"], m42c, ("time", 0))

    # TestPackedWidebandEnergy: packed and fused on the first 4 ranks
    cfg = WidebandConfig()
    m4 = mesh["time4"]
    if m4 is not None:
        xr, xi = (torch.from_numpy(v) for v in inp["packed"])
        got = sharded_wideband_energy_packed(xr, xi, m4, cfg, precision="highest")
        out["packed"] = _gather(got, m4, ("time", 0))
        xr, xi = (torch.from_numpy(v) for v in inp["fused"])
        got = sharded_wideband_energy_fused(xr, xi, m4, cfg, precision="highest")
        out["fused"] = _gather(got, m4, ("time", 0))
    # the fast path's routing, planes and a planar tuple (make_wideband_fn)
    route = inp["route"]
    fast = wideband_sense(route, torch.from_numpy(cfg.taps()), cfg, mesh=m42c)
    planar = make_wideband_fn(cfg, mesh=m42c, device="cpu")(
        (route[:, 0].copy(), route[:, 1].copy())
    )
    out["route"] = {
        name: {
            "energy": _gather(r["energy"], m42c, ("channel", 1), ("time", 0)),
            "noise": _gather(r["noise"], m42c, ("time", 0)),
        }
        for name, r in (("fast", fast), ("planar", planar))
    }

    # TestBatchedWidebandFastPath, with the channelizer made to raise
    cfg_b = WidebandConfig(num_channels=16, taps_per_channel=8, block_len=8)
    called = []

    def refuse(*a, **k):
        called.append(1)
        raise AssertionError("channelizer fallback used")

    saved = chan_mod.channelize_planes, halo_mod.channelize_planes
    chan_mod.channelize_planes = halo_mod.channelize_planes = refuse
    try:
        res = wideband_sense(
            inp["batch"], torch.from_numpy(cfg_b.taps()), cfg_b, mesh=m42d, batch_axis="data"
        )
    finally:
        chan_mod.channelize_planes, halo_mod.channelize_planes = saved
    out["batch"] = _gather(res["energy"], m42d, ("time", 1), ("data", 0))
    out["batch_channelizer_calls"] = len(called)
    return out


@pytest.fixture(scope="module")
def fleet():
    inp = _inputs()
    results = run_ranks(_rank, WORLD, backend="gloo", device="cpu", args=(inp,), timeout_s=300)
    return inp, results


def _jax():
    import jax
    import jax.numpy as jnp

    from cognitive_radio_network_tpu import parallel as jpar

    return jax, jnp, jpar


class TestMesh:
    def test_axes_and_layout_match_the_jax_mesh(self, fleet):
        jax, _, jpar = _jax()
        _, results = fleet
        specs = {
            "time8": MeshSpec(time=8),
            "time4_data2": MeshSpec(time=4, data=2),
            "time4_channel2": MeshSpec(time=4, channel=2),
            "time2_channel2_data2": MeshSpec(time=2, channel=2, data=2),
            "time4": MeshSpec(time=4),
            "one": MeshSpec(),
        }
        for key, spec in specs.items():
            jmesh = jpar.make_mesh(jpar.MeshSpec(spec.time, spec.channel, spec.data))
            ids = np.vectorize(lambda d: d.id)(jmesh.devices).tolist()
            for rank, res in enumerate(results):
                got = res["meshes"][key]
                if rank >= spec.total:
                    assert got is None, (key, rank)
                    continue
                names, layout, coord = got
                assert names == tuple(jmesh.axis_names), key
                assert layout == ids, key
                assert np.asarray(layout)[tuple(coord)] == rank

    def test_too_many_ranks_raise(self, fleet):
        _, results = fleet
        assert all("needs 16 ranks, the world has 8" in r["too_big"] for r in results)


class TestHaloExchange:
    def test_shard_zero_gets_zeros_the_rest_their_left_tail(self, fleet):
        _, results = fleet
        got = results[0]["halo"]
        for r in range(WORLD):
            blk = np.arange(6.0) + 100 * r
            left = np.zeros(2) if r == 0 else (np.arange(6.0) + 100 * (r - 1))[-2:]
            np.testing.assert_array_equal(got[r], np.concatenate([left, blk]))
        for res in results[1:]:
            np.testing.assert_array_equal(res["halo"], got)

    def test_along_axis_1_matches_jax(self, fleet):
        jax, jnp, jpar = _jax()
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        from cognitive_radio_network_tpu.parallel.halo import halo_exchange as jax_halo

        _, results = fleet
        whole = np.concatenate(
            [np.stack([np.arange(6.0) + 100 * r, -(np.arange(6.0) + 100 * r)]) for r in range(WORLD)],
            axis=1,
        ).astype(np.float32)
        mesh = jpar.make_mesh(jpar.MeshSpec(time=8))
        want = shard_map(
            lambda x: jax_halo(x, 3, "time", axis=1)[None],
            mesh=mesh, in_specs=P(None, "time"), out_specs=P("time"), check_vma=False,
        )(jnp.asarray(whole))
        np.testing.assert_array_equal(results[0]["halo_axis1"], np.asarray(want))

    def test_halo_longer_than_the_block_raises(self, fleet):
        _, results = fleet
        assert all("halo 7 must be in [1, 6]" in r["halo_too_long"] for r in results)


class TestShardedChannelize:
    def test_matches_single_device_and_jax(self, fleet):
        jax, jnp, jpar = _jax()
        inp, results = fleet
        taps = polyphase_taps(16, 8)
        want = channelize_planes(torch.from_numpy(inp["channelize"]), taps).numpy()
        np.testing.assert_allclose(results[0]["channelize"], want, rtol=1e-4, atol=1e-5)
        jwant = jpar.sharded_channelize(
            jnp.asarray(inp["channelize"]), jnp.asarray(taps), jpar.make_mesh(jpar.MeshSpec(time=8))
        )
        np.testing.assert_allclose(results[0]["channelize"], np.asarray(jwant), rtol=1e-4, atol=1e-5)

    def test_batched_data_parallel(self, fleet):
        jax, jnp, jpar = _jax()
        inp, results = fleet
        taps = polyphase_taps(8, 4)
        want = channelize_planes(torch.from_numpy(inp["channelize_batch"]), taps).numpy()
        np.testing.assert_allclose(results[0]["channelize_batch"], want, rtol=1e-4, atol=1e-5)
        jwant = jpar.sharded_channelize(
            jnp.asarray(inp["channelize_batch"]), jnp.asarray(taps),
            jpar.make_mesh(jpar.MeshSpec(time=4, data=2)), batch_axis="data",
        )
        np.testing.assert_allclose(
            results[0]["channelize_batch"], np.asarray(jwant), rtol=1e-4, atol=1e-5
        )


class TestWideband:
    def test_energy_detector_finds_active_channels(self, fleet):
        jax, jnp, jpar = _jax()
        inp, results = fleet
        got = results[0]["tones"]
        occ = got["occupied"][1:]  # the first cycle holds the filter's warm-up
        for k in range(16):
            if k in ACTIVE:
                assert occ[:, k].all(), f"channel {k} should be occupied"
            else:
                assert not occ[:, k].any(), f"channel {k} should be free"
        cfg = WidebandConfig(num_channels=16, taps_per_channel=8, block_len=64)
        one = wideband_sense(torch.from_numpy(inp["tones"]), torch.from_numpy(cfg.taps()), cfg)
        np.testing.assert_allclose(got["energy"], one["energy"].numpy(), rtol=1e-6, atol=1e-9)
        np.testing.assert_array_equal(got["occupied"], one["occupied"].numpy())
        jcfg = jpar.WidebandConfig(num_channels=16, taps_per_channel=8, block_len=64)
        want = jpar.wideband_sense(
            jnp.asarray(inp["tones"]), jnp.asarray(jcfg.taps()),
            jpar.make_mesh(jpar.MeshSpec(time=4, channel=2)), jcfg,
        )
        np.testing.assert_allclose(got["energy"], np.asarray(want["energy"]), rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(got["occupied"], np.asarray(want["occupied"]))


class TestPackedWidebandEnergy:
    def test_sharded_packed_equals_single_device_and_jax(self, fleet):
        jax, jnp, jpar = _jax()
        from jax.sharding import Mesh

        from cognitive_radio_network_tpu.parallel.wideband import (
            sharded_wideband_energy_packed as jax_packed,
        )

        inp, results = fleet
        cfg = WidebandConfig()
        xr, xi = inp["packed"]
        single = wideband_energy_packed(
            torch.from_numpy(xr), torch.from_numpy(xi), cfg.taps(), cfg, precision="highest"
        )
        np.testing.assert_allclose(results[0]["packed"], single.numpy(), rtol=1e-6, atol=1e-9)
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(4), ("time",))
        want = jax.jit(
            lambda a, b: jax_packed(a, b, mesh, jpar.WidebandConfig(), precision="highest")
        )(jnp.asarray(xr), jnp.asarray(xi))
        np.testing.assert_allclose(results[0]["packed"], np.asarray(want), rtol=1e-5, atol=1e-7)
        for res in results[1:4]:
            np.testing.assert_array_equal(res["packed"], results[0]["packed"])
        assert all("packed" not in res for res in results[4:])  # not in the 4-rank mesh

    def test_sharded_fused_equals_single_fused_and_jax(self, fleet):
        jax, jnp, jpar = _jax()
        from jax.sharding import Mesh

        from cognitive_radio_network_tpu.parallel.wideband import (
            sharded_wideband_energy_fused as jax_fused,
        )

        inp, results = fleet
        cfg = WidebandConfig()
        xr, xi = inp["fused"]
        single = wideband_energy_fused(
            torch.from_numpy(xr), torch.from_numpy(xi), cfg.taps(), cfg, precision="highest"
        )
        np.testing.assert_allclose(results[0]["fused"], single.numpy(), rtol=1e-6, atol=1e-9)
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(4), ("time",))
        want = jax.jit(
            lambda a, b: jax_fused(
                a, b, mesh, jpar.WidebandConfig(), precision="highest", interpret=True
            )
        )(jnp.asarray(xr), jnp.asarray(xi))
        np.testing.assert_allclose(results[0]["fused"], np.asarray(want), rtol=1e-5, atol=1e-7)

    def test_wideband_sense_routes_energy_fast_path(self, fleet):
        jax, jnp, jpar = _jax()
        inp, results = fleet
        route = inp["route"]
        cfg = WidebandConfig()
        got = results[0]["route"]
        chan = channelize_planes(torch.from_numpy(route), cfg.taps()).numpy()
        power = chan[..., 0] ** 2 + chan[..., 1] ** 2
        want = power.reshape(-1, cfg.block_len, 64).mean(axis=1)
        np.testing.assert_allclose(got["fast"]["energy"], want, rtol=2e-4, atol=1e-7)
        for k in ("energy", "noise"):
            np.testing.assert_allclose(got["planar"][k], got["fast"][k], rtol=1e-6, atol=0)
        one = wideband_sense(torch.from_numpy(route), torch.from_numpy(cfg.taps()), cfg)
        for k in ("energy", "noise"):
            np.testing.assert_allclose(got["fast"][k], one[k].numpy(), rtol=1e-6, atol=1e-9)
        jcfg = jpar.WidebandConfig()
        jwant = jpar.wideband_sense(
            jnp.asarray(route), jnp.asarray(jcfg.taps()),
            jpar.make_mesh(jpar.MeshSpec(time=4, channel=2)), jcfg,
        )
        for k in ("energy", "noise"):
            np.testing.assert_allclose(got["fast"][k], np.asarray(jwant[k]), rtol=1e-5, atol=1e-7)


class TestBatchedWidebandFastPath:
    def test_batched_matches_per_row_single_device_and_jax(self, fleet):
        jax, jnp, jpar = _jax()
        from jax.sharding import Mesh

        inp, results = fleet
        cfg = WidebandConfig(num_channels=16, taps_per_channel=8, block_len=8)
        planes = inp["batch"]
        got = results[0]["batch"]
        assert got.shape == (4, 64 // cfg.block_len, 16)
        for i in range(4):
            ref = wideband_energy_packed(
                torch.from_numpy(planes[i, :, 0].copy()), torch.from_numpy(planes[i, :, 1].copy()),
                cfg.taps(), cfg,
            ).numpy()
            np.testing.assert_allclose(got[i], ref, rtol=1e-6, atol=1e-9)
        jcfg = jpar.WidebandConfig(num_channels=16, taps_per_channel=8, block_len=8)
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "time"))
        want = jpar.wideband_sense(
            jnp.asarray(planes), jnp.asarray(jcfg.taps()), mesh, jcfg, batch_axis="data"
        )
        np.testing.assert_allclose(got, np.asarray(want["energy"]), rtol=2e-3, atol=1e-5)

    def test_batched_avoids_channelizer(self, fleet):
        _, results = fleet
        assert all(r["batch_channelizer_calls"] == 0 for r in results)
