"""Port parity: the wideband train step (PyTorch, one device) vs the JAX package.

The JAX ``make_sharded_train_step`` runs on a one-device mesh, the port's
``make_sharded_train_step`` on the CPU, from the same parameters (JAX
``init_fn(key(1))`` as numpy) and the same numpy batch.  At
``WidebandConfig(num_channels=8, taps_per_channel=4, block_len=16)`` the port
senses through the packed plain path; at M=64, P=8 through the wideband
kernel's plain version (on the CPU), with a short T.  Tolerance: each of 20
steps' losses rtol 1e-5 (float32 on both sides; the energies agree to rtol
1e-5, tests/test_torch_wideband.py).  Convergence is held by
tests/test_distributed_training.py::test_loss_decreases_and_classifies's own
thresholds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cognitive_radio_network_tpu.models.distributed import (
    make_sharded_train_step as jax_make_sharded_train_step,
)
from cognitive_radio_network_tpu.parallel import MeshSpec, make_mesh
from cognitive_radio_network_tpu.parallel import WidebandConfig as JaxWidebandConfig
from cognitive_radio_network_tpu_torch.models.distributed import (
    make_sharded_apply,
    make_sharded_train_step,
)
from cognitive_radio_network_tpu_torch.models.train import TrainState, make_optimizer, TrainConfig
from cognitive_radio_network_tpu_torch.parallel.wideband import WidebandConfig
from cognitive_radio_network_tpu_torch.signal.mlp import OccupancyMLP, params_from_numpy


def _make_batch(rng, m, block_len, b, t_total, tone_amp=1.0):
    """tests/test_distributed_training.py::_make_batch: wide streams with
    random per-cycle-constant channel activity, as numpy planes and labels."""
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


@pytest.mark.parametrize(
    "kw,t_total",
    [
        (dict(num_channels=8, taps_per_channel=4, block_len=16), 32),  # the packed path
        (dict(), 256),  # M=64, P=8: the wideband kernel's plain version
    ],
    ids=["packed-M8", "fused-M64"],
)
def test_step_losses_match_jax_for_20_steps(rng, kw, t_total):
    jcfg, cfg = JaxWidebandConfig(**kw), WidebandConfig(**kw)
    planes, labels = _make_batch(rng, cfg.num_channels, cfg.block_len, 4, t_total)
    j_init, j_step = jax_make_sharded_train_step(make_mesh(MeshSpec()), jcfg)
    jstate = j_init(jax.random.key(1))
    mlp = params_from_numpy(*(np.asarray(v) for v in jstate.params))
    _, step_fn = make_sharded_train_step(cfg, device="cpu")
    state = TrainState(mlp, make_optimizer(TrainConfig(learning_rate=1e-3), mlp), 0)
    want, got = [], []
    for _ in range(20):
        jstate, loss = j_step(jstate, jnp.asarray(planes), jnp.asarray(labels))
        want.append(float(loss))
        state, loss = step_fn(state, planes, labels)
        got.append(loss.item())
    assert state.step == 20 and int(jstate.step) == 20
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for name in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(getattr(state.params, name).detach().numpy(),
                                   np.asarray(getattr(jstate.params, name)), atol=1e-5)


def test_init_fn_draws_a_4_5_1_network_with_its_optimizer():
    init_fn, _ = make_sharded_train_step(WidebandConfig(), 5e-2, device="cpu")
    state = init_fn(torch.Generator().manual_seed(0))
    again = init_fn(torch.Generator().manual_seed(0))
    assert isinstance(state.params, OccupancyMLP) and state.step == 0
    assert tuple(state.params.w1.shape) == (4, 5) and tuple(state.params.w2.shape) == (5, 1)
    assert torch.equal(state.params.w1, again.params.w1) and not state.params.b1.any()
    assert state.opt.param_groups[0]["lr"] == 5e-2
    assert state.opt.param_groups[0]["betas"] == (0.9, 0.999)
    assert state.opt.param_groups[0]["eps"] == 1e-8


def test_loss_decreases_and_classifies(rng):
    """tests/test_distributed_training.py::test_loss_decreases_and_classifies
    on the port: 150 steps at lr 3e-2, the loss halves and ends below 0.2,
    and the apply step classifies more than 95% of the channel-cycles."""
    cfg = WidebandConfig(num_channels=8, taps_per_channel=4, block_len=32)
    init_fn, step_fn = make_sharded_train_step(cfg, learning_rate=3e-2, device="cpu")
    state = init_fn(torch.Generator().manual_seed(0))
    planes, labels = _make_batch(rng, cfg.num_channels, cfg.block_len, 8, 4 * cfg.block_len)
    planes = torch.from_numpy(planes)
    losses = []
    for _ in range(150):
        state, loss = step_fn(state, planes, labels)
        losses.append(loss)
    losses = torch.stack(losses).numpy()
    assert losses[-1] < losses[0] * 0.5
    assert losses[-1] < 0.2
    probs = make_sharded_apply(cfg, device="cpu")(state.params, planes).numpy()
    acc = np.mean((probs > 0.5) == (labels > 0.5))
    assert acc > 0.95


def test_the_step_senses_without_gradient_and_trains_only_the_network(rng):
    cfg = WidebandConfig(num_channels=8, taps_per_channel=4, block_len=16)
    init_fn, step_fn = make_sharded_train_step(cfg, device="cpu")
    state = init_fn(torch.Generator().manual_seed(2))
    planes, labels = _make_batch(rng, 8, 16, 2, 32)
    planes = torch.from_numpy(planes).requires_grad_(True)
    before = [p.detach().clone() for p in state.params.parameters()]
    state, loss = step_fn(state, planes, labels)
    assert planes.grad is None and not loss.requires_grad and loss.dim() == 0
    assert all(not torch.equal(a, b) for a, b in zip(before, state.params.parameters()))
