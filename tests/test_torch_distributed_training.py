"""Port parity: the sharded wideband train and apply steps (PyTorch, gloo ranks
on the CPU) vs the JAX package's sharded steps and the port's one-device step.

Mirrors tests/test_distributed_training.py (convergence on a (time=2,
channel=2, data=2) mesh, mesh invariance of the loss, the features' cyclic
neighbours) and the two fleets of tests/test_multihost.py: ranks started
through ``parallel/multihost.py`` (here by ``parallel/launch.py::run_ranks``,
2 and 4 processes, one device each) run one sharded step on a global mesh,
and every rank returns the same loss.  Both packages start from the same
parameters (the JAX ``init_fn``'s, as numpy) and the same numpy batch.  No
JAX at module level: the ranks import this file.

Tolerances: the reference's own (losses of the same data and parameters
within rtol 1e-5 across meshes and packages; the loss under half its start
and under 0.2 after 150 steps; accuracy above 0.95); the ranks' losses
within 1e-6 of each other (tests/test_multihost.py:160).
"""

import numpy as np
import pytest
import torch

from cognitive_radio_network_tpu_torch.models.distributed import (
    make_sharded_apply,
    make_sharded_train_step,
    wideband_features,
)
from cognitive_radio_network_tpu_torch.models.train import TrainConfig, TrainState, make_optimizer
from cognitive_radio_network_tpu_torch.parallel import MeshSpec, WidebandConfig, make_mesh
from cognitive_radio_network_tpu_torch.parallel import multihost
from cognitive_radio_network_tpu_torch.parallel.collectives import all_gather
from cognitive_radio_network_tpu_torch.parallel.launch import run_ranks
from cognitive_radio_network_tpu_torch.signal.mlp import params_from_numpy

CONVERGE = dict(num_channels=8, taps_per_channel=4, block_len=32)
INVARIANT = dict(num_channels=8, taps_per_channel=4, block_len=16)
MESH8 = MeshSpec(time=2, channel=2, data=2)
STEPS, COMPARED = 150, 20


def _make_batch(rng, m, block_len, b, t_total, tone_amp=1.0):
    """tests/test_distributed_training.py::_make_batch, as numpy planes."""
    c = t_total // block_len
    labels = rng.integers(0, 2, (b, 1, m)).repeat(c, axis=1).astype(np.float32)
    x = 0.01 * (
        rng.standard_normal((b, t_total * m)) + 1j * rng.standard_normal((b, t_total * m))
    ).astype(np.complex64)
    n = np.arange(t_total * m)
    for i in range(b):
        for k in range(m):
            if labels[i, 0, k]:
                x[i] += tone_amp * np.exp(2j * np.pi * (k / m) * n + 1j * rng.uniform(0, 6.28))
    return np.stack([x.real, x.imag], axis=-1).astype(np.float32), labels


def _state(params, lr):
    mlp = params_from_numpy(*params)
    return TrainState(mlp, make_optimizer(TrainConfig(lr), mlp), 0)


def _numpy_params(state) -> tuple:
    return tuple(getattr(state.params, k).detach().numpy().copy() for k in ("w1", "b1", "w2", "b2"))


def _train_rank(inp: dict) -> dict:
    """The world of 8: 150 steps and the apply step on (2, 2, 2); one step
    of the invariance batch; ``init_fn``'s broadcast."""
    import torch.distributed as dist

    mesh = make_mesh(MESH8, device="cpu")
    cfg = WidebandConfig(**CONVERGE)
    _, step_fn = make_sharded_train_step(cfg, learning_rate=3e-2, mesh=mesh, device="cpu")
    state = _state(inp["converge_params"], 3e-2)
    planes, labels = inp["converge"]
    losses = []
    for _ in range(STEPS):
        state, loss = step_fn(state, planes, labels)
        losses.append(loss.item())
    probs = make_sharded_apply(cfg, mesh=mesh, device="cpu")(state.params, planes)
    for name, dim in (("channel", 2), ("time", 1), ("data", 0)):
        probs = all_gather(probs, mesh, name, dim)

    cfg = WidebandConfig(**INVARIANT)
    init_fn, step_fn = make_sharded_train_step(cfg, mesh=mesh, device="cpu")
    _, loss = step_fn(_state(inp["invariant_params"], 1e-3), *inp["invariant"])
    drawn = init_fn(torch.Generator().manual_seed(dist.get_rank()))  # rank 0's must win
    return {
        "losses": losses,
        "probs": probs.numpy(),
        "invariant_loss": loss.item(),
        "drawn": _numpy_params(drawn),
    }


def _multihost_rank(nprocs: int) -> dict:
    """tests/multihost_worker.py: one sharded step on a global (time=2,
    channel=nprocs/2) mesh, the batch the same on every rank by its seed."""
    import torch.distributed as dist

    assert multihost.is_distributed() and dist.get_world_size() == nprocs
    spec = MeshSpec(time=2, channel=nprocs // 2)
    mesh = multihost.global_mesh(spec, device="cpu")
    assert mesh.size() == nprocs
    cfg = WidebandConfig(**INVARIANT)
    m = cfg.num_channels
    t_total = spec.time * 2 * cfg.block_len
    b, c = 2, t_total // cfg.block_len
    rng = np.random.default_rng(0)  # same seed everywhere -> same global data
    planes = rng.standard_normal((b, t_total * m, 2)).astype(np.float32)
    labels = rng.integers(0, 2, (b, c, m)).astype(np.float32)
    init_fn, step_fn = make_sharded_train_step(cfg, mesh=mesh, device="cpu")
    state = init_fn(torch.Generator().manual_seed(0))
    params = _numpy_params(state)
    state, loss = step_fn(state, planes, labels)
    out = {"loss": loss.item(), "params": params, "planes": planes, "labels": labels}
    if nprocs == 2:  # a mesh with no time axis: the batch split along data alone
        _, step_fn = make_sharded_train_step(cfg, mesh=multihost.global_mesh(
            MeshSpec(data=2), device="cpu"), device="cpu")
        out["data_loss"] = step_fn(_state(params, 1e-3), planes, labels)[1].item()
    multihost.host_local_sync(7)
    return out


def _jax_state(params, lr):
    import jax.numpy as jnp
    import optax

    from cognitive_radio_network_tpu.models.train import TrainState as JaxState
    from cognitive_radio_network_tpu.signal.mlp import MLPParams

    p = MLPParams(*(jnp.asarray(v) for v in params))
    return JaxState(p, optax.adam(lr).init(p), jnp.int32(0))


def _jax_step(spec, kw, lr=1e-3):
    from cognitive_radio_network_tpu.models.distributed import make_sharded_train_step as jstep
    from cognitive_radio_network_tpu.parallel import MeshSpec as JaxSpec
    from cognitive_radio_network_tpu.parallel import WidebandConfig as JaxConfig
    from cognitive_radio_network_tpu.parallel import make_mesh as jax_mesh

    mesh = jax_mesh(JaxSpec(spec.time, spec.channel, spec.data))
    return jstep(mesh, JaxConfig(**kw), learning_rate=lr)


@pytest.fixture(scope="module")
def fleet():
    import jax

    rng = np.random.default_rng(1234)
    converge = _make_batch(rng, 8, 32, b=8, t_total=4 * 32)
    invariant = _make_batch(rng, 8, 16, b=4, t_total=2 * 16)
    init, _ = _jax_step(MeshSpec(), CONVERGE)
    inp = {
        "converge": converge,
        "invariant": invariant,
        "converge_params": tuple(np.asarray(v) for v in init(jax.random.key(0)).params),
        "invariant_params": tuple(np.asarray(v) for v in init(jax.random.key(1)).params),
    }
    results = run_ranks(_train_rank, 8, backend="gloo", device="cpu", args=(inp,), timeout_s=300)
    return inp, results


class TestShardedTraining:
    def test_loss_decreases_and_classifies(self, fleet):
        inp, results = fleet
        losses = results[0]["losses"]
        assert all(r["losses"] == losses for r in results)
        assert losses[-1] < losses[0] * 0.5
        assert losses[-1] < 0.2
        labels = inp["converge"][1]
        acc = np.mean((results[0]["probs"] > 0.5) == (labels > 0.5))
        assert acc > 0.95

    def test_losses_match_jax_sharded_and_one_device(self, fleet):
        import jax.numpy as jnp

        inp, results = fleet
        planes, labels = inp["converge"]
        _, jstep = _jax_step(MESH8, CONVERGE, lr=3e-2)
        jstate = _jax_state(inp["converge_params"], 3e-2)
        _, one_step = make_sharded_train_step(
            WidebandConfig(**CONVERGE), learning_rate=3e-2, device="cpu"
        )
        state = _state(inp["converge_params"], 3e-2)
        want, one = [], []
        for _ in range(COMPARED):
            jstate, loss = jstep(jstate, jnp.asarray(planes), jnp.asarray(labels))
            want.append(float(loss))
            state, loss = one_step(state, planes, labels)
            one.append(loss.item())
        got = results[0]["losses"][:COMPARED]
        np.testing.assert_allclose(got, one, rtol=1e-5)
        np.testing.assert_allclose(got, want, rtol=1e-5)

    def test_mesh_invariance(self, fleet):
        """Same data, same parameters: the one-device step (port), the JAX
        step on 1 and 8 devices and the port's 8 ranks give one loss."""
        import jax.numpy as jnp

        inp, results = fleet
        planes, labels = inp["invariant"]
        _, one_step = make_sharded_train_step(WidebandConfig(**INVARIANT), device="cpu")
        _, one = one_step(_state(inp["invariant_params"], 1e-3), planes, labels)
        losses = [one.item()]
        for spec in (MeshSpec(), MESH8):
            _, jstep = _jax_step(spec, INVARIANT)
            _, loss = jstep(_jax_state(inp["invariant_params"], 1e-3), jnp.asarray(planes),
                            jnp.asarray(labels))
            losses.append(float(loss))
        for r in results:
            np.testing.assert_allclose(r["invariant_loss"], losses, rtol=1e-5)

    def test_init_fn_broadcasts_rank_zero_parameters(self, fleet):
        _, results = fleet
        for r in results[1:]:
            for a, b in zip(r["drawn"], results[0]["drawn"]):
                np.testing.assert_array_equal(a, b)


class TestWidebandFeatures:
    def test_neighbor_wrap(self):
        e = torch.arange(8, dtype=torch.float32)[None, None, :]
        f = wideband_features(e, torch.zeros((1, 1, 1)))[0, 0].numpy()
        assert f[0, 1] == 7  # left neighbour of channel 0 wraps to 7
        assert f[7, 3] == 0  # right neighbour of channel 7 wraps to 0
        assert (f[:, 2] == np.arange(8)).all()


@pytest.fixture(scope="module")
def process_fleets():
    """tests/test_multihost.py's fleets: 2 and 4 ranks, each started once."""
    return {
        n: run_ranks(_multihost_rank, n, backend="gloo", device="cpu", args=(n,), timeout_s=240)
        for n in (2, 4)
    }


class TestMultiProcessDistributed:
    """tests/test_multihost.py's two fleets, as ranks of the port."""

    @pytest.mark.parametrize("nprocs", [2, 4])
    def test_process_fleet_sharded_train_step(self, process_fleets, nprocs):
        import jax.numpy as jnp

        results = process_fleets[nprocs]
        losses = [r["loss"] for r in results]
        assert np.isfinite(losses).all()
        assert max(losses) - min(losses) <= 1e-6  # the replicated loss agrees
        first = results[0]
        for r in results[1:]:
            for a, b in zip(r["params"], first["params"]):
                np.testing.assert_array_equal(a, b)
        _, one_step = make_sharded_train_step(WidebandConfig(**INVARIANT), device="cpu")
        _, one = one_step(_state(first["params"], 1e-3), first["planes"], first["labels"])
        spec = MeshSpec(time=2, channel=nprocs // 2)
        _, jstep = _jax_step(spec, INVARIANT)
        _, want = jstep(_jax_state(first["params"], 1e-3), jnp.asarray(first["planes"]),
                        jnp.asarray(first["labels"]))
        np.testing.assert_allclose(losses[0], [one.item(), float(want)], rtol=1e-5)

    def test_data_axis_alone_matches_one_device(self, process_fleets):
        """A (data=2) mesh: the port takes the absent time axis as size 1 and
        gives the one-device loss.  The reference's ``wideband_sense`` sends a
        mesh without ``time`` to ``sharded_channelize`` over a ``time`` axis
        the mesh lacks, which ``shard_map`` refuses (ROADMAP.md Queue 3)."""
        import jax.numpy as jnp

        results = process_fleets[2]
        first = results[0]
        _, one_step = make_sharded_train_step(WidebandConfig(**INVARIANT), device="cpu")
        _, one = one_step(_state(first["params"], 1e-3), first["planes"], first["labels"])
        for r in results:
            np.testing.assert_allclose(r["data_loss"], one.item(), rtol=1e-5)
        _, jstep = _jax_step(MeshSpec(data=2), INVARIANT)
        with pytest.raises(ValueError, match="shard_map in_specs"):
            jstep(_jax_state(first["params"], 1e-3), jnp.asarray(first["planes"]),
                  jnp.asarray(first["labels"]))
