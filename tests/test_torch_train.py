"""Port parity: classifier training and training state (PyTorch) vs the JAX package.

The same numpy arrays go through both packages; no seed is shared between
them (``jax.random`` and ``torch.Generator`` streams never agree).  The start
is JAX ``init_mlp(key(1))`` as numpy, the data JAX ``make_dataset`` as numpy.

Tolerances: the loss rtol 1e-6 and its gradient rtol 1e-5 (one float32
forward and backward, summed in another order); 200 steps of ``fit``: the
losses rtol 1e-4 and the final parameters atol 1e-4 (Adam's update in float32,
its bias corrections in float64 on the port's side); features of
``make_dataset`` rtol 1e-4, the bound of tests/test_torch_sense.py against the
JAX ``sense_classify``.  The end result of training is held by the reference's
own criteria (tests/test_io_tools.py::TestTraining and
tests/test_scenarios.py:173-231).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cognitive_radio_network_tpu.env import markov_pu_trace as jax_markov_pu_trace
from cognitive_radio_network_tpu.env.scene import occupancy_to_powers as jax_occupancy_to_powers
from cognitive_radio_network_tpu.env.scene import synthesize_scene as jax_synthesize_scene
from cognitive_radio_network_tpu.io.checkpoint import load_mlp_with_meta as jax_load_mlp_with_meta
from cognitive_radio_network_tpu.io.checkpoint import load_state as jax_load_state
from cognitive_radio_network_tpu.io.checkpoint import save_state as jax_save_state
from cognitive_radio_network_tpu.models import SenseConfig as JaxSenseConfig
from cognitive_radio_network_tpu.models import sense_classify as jax_sense_classify
from cognitive_radio_network_tpu.models import train as jtrain
from cognitive_radio_network_tpu.signal.mlp import MLPParams
from cognitive_radio_network_tpu.signal.mlp import init_mlp as jax_init_mlp
from cognitive_radio_network_tpu.signal.mlp import reference_weights as jax_reference_weights
from cognitive_radio_network_tpu_torch import runtime as trt
from cognitive_radio_network_tpu_torch.io.checkpoint import (
    load_mlp_with_meta,
    load_state,
    save_mlp,
    save_state,
)
from cognitive_radio_network_tpu_torch.models import SenseConfig, sense_classify
from cognitive_radio_network_tpu_torch.models import train as ttrain
from cognitive_radio_network_tpu_torch.signal.mlp import (
    OccupancyMLP,
    init_mlp,
    params_from_numpy,
    reference_weights,
)

ROOT = Path(__file__).resolve().parents[1]
_NAMES = ("w1", "b1", "w2", "b2")


def _np(params):
    """The four arrays of a JAX MLPParams or a port OccupancyMLP, as numpy."""
    if isinstance(params, OccupancyMLP):
        return [getattr(params, n).detach().cpu().numpy() for n in _NAMES]
    return [np.asarray(getattr(params, n)) for n in _NAMES]


def _port_state(jax_params, lr=3e-3) -> ttrain.TrainState:
    params = params_from_numpy(*_np(jax_params))
    return ttrain.TrainState(params, ttrain.make_optimizer(ttrain.TrainConfig(lr), params), 0)


def _fresh(arrays) -> MLPParams:
    """JAX parameters in buffers of their own (the JAX train step donates its state)."""
    return MLPParams(*(jnp.array(a, copy=True) for a in arrays))


@pytest.fixture(scope="module")
def jax_data_np():
    feats, labels = jtrain.make_dataset(jax.random.key(0), 200)
    return np.array(feats), np.array(labels), _np(jax_init_mlp(jax.random.key(1)))


@pytest.fixture
def jax_data(jax_data_np):
    """JAX make_dataset(key(0), 200) as numpy and JAX init_mlp(key(1)) in fresh buffers."""
    feats, labels, start = jax_data_np
    return feats, labels, _fresh(start)


# --- init_mlp --------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 5, 3), (4, 5, 1), (7, 2, 9)])
def test_init_mlp_glorot_bounds_zero_biases_and_determinism(shape):
    n_in, n_hidden, n_out = shape
    mlp = init_mlp(torch.Generator().manual_seed(3), *shape)
    again = init_mlp(torch.Generator().manual_seed(3), *shape)
    other = init_mlp(torch.Generator().manual_seed(4), *shape)
    assert tuple(mlp.w1.shape) == (n_in, n_hidden) and tuple(mlp.w2.shape) == (n_hidden, n_out)
    for w, fan in ((mlp.w1, n_in + n_hidden), (mlp.w2, n_hidden + n_out)):
        s = np.sqrt(6.0 / fan)
        top = float(w.detach().abs().max())
        assert 0.3 * s < top <= s  # drawn over the whole range
    assert not mlp.b1.any() and not mlp.b2.any()
    assert all(torch.equal(a, b) for a, b in zip(mlp.parameters(), again.parameters()))
    assert not torch.equal(mlp.w1, other.w1)
    assert all(p.device.type == "cpu" and p.dtype == torch.float32 for p in mlp.parameters())
    assert init_mlp(torch.Generator(), *shape, dtype=torch.float64).w1.dtype == torch.float64


# --- the loss, one step, fit ----------------------------------------------


@pytest.mark.parametrize(
    "tcfg", [jtrain.TrainConfig(), jtrain.TrainConfig(feature_scale=10.0)], ids=["log1p", "scaled"]
)
def test_loss_and_gradient_match_jax(jax_data, tcfg):
    feats, labels, jp = jax_data
    want = jtrain._loss_fn(jp, jnp.asarray(feats), jnp.asarray(labels), tcfg)
    want_g = jax.grad(jtrain._loss_fn)(jp, jnp.asarray(feats), jnp.asarray(labels), tcfg)
    mlp = params_from_numpy(*_np(jp))
    port_cfg = ttrain.TrainConfig(**dataclasses.asdict(tcfg))
    loss = ttrain._loss_fn(mlp, torch.from_numpy(feats), torch.from_numpy(labels), port_cfg)
    grads = torch.autograd.grad(loss, [getattr(mlp, n) for n in _NAMES])
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6)
    for g, w in zip(grads, _np(want_g)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-7 * np.abs(w).max())


def test_loss_without_log_features_matches_jax(jax_data):
    """Raw features saturate the sigmoids: the clip keeps the loss finite."""
    feats, labels, jp = jax_data
    tcfg = jtrain.TrainConfig(log_features=False)
    want = jtrain._loss_fn(jp, jnp.asarray(feats), jnp.asarray(labels), tcfg)
    loss = ttrain._loss_fn(params_from_numpy(*_np(jp)), torch.from_numpy(feats),
                           torch.from_numpy(labels), ttrain.TrainConfig(log_features=False))
    assert np.isfinite(loss.item())
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6)


def test_config_defaults_equal_jax():
    assert dataclasses.asdict(ttrain.TrainConfig()) == dataclasses.asdict(jtrain.TrainConfig())


def test_fit_200_steps_matches_jax(jax_data):
    feats, labels, jp = jax_data
    start = params_from_numpy(*_np(jp))
    tcfg = jtrain.TrainConfig(num_steps=200)
    want_p, want_l = jtrain.fit(jax.random.key(1), jnp.asarray(feats), jnp.asarray(labels), tcfg,
                                params=jp)
    before = [p.clone() for p in start.parameters()]
    got_p, got_l = ttrain.fit(None, feats, labels, ttrain.TrainConfig(num_steps=200),
                              params=start, device="cpu")
    assert got_l.shape == (200,) and got_p is not start
    # the start is copied, not trained in place
    assert all(torch.equal(a, b) for a, b in zip(before, start.parameters()))
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4)
    for g, w in zip(_np(got_p), _np(want_p)):
        np.testing.assert_allclose(g, w, atol=1e-4)


def test_fit_of_zero_steps_returns_the_start():
    feats, labels = np.ones((4, 4), np.float32), np.zeros((4, 3), np.float32)
    params, losses = ttrain.fit(torch.Generator().manual_seed(1), feats, labels,
                                ttrain.TrainConfig(num_steps=0), device="cpu")
    assert losses.shape == (0,)
    want = init_mlp(torch.Generator().manual_seed(1))
    assert all(torch.equal(a, b) for a, b in zip(params.parameters(), want.parameters()))


def test_train_step_runs_in_full_f32_whatever_the_callers_flags(jax_data):
    """The step sets TF32 off around forward and backward, and restores the flags."""
    feats, labels, jp = jax_data
    state = _port_state(jp)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        state, loss = ttrain.train_step(state, torch.from_numpy(feats), torch.from_numpy(labels),
                                        ttrain.TrainConfig())
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert state.step == 1 and loss.dim() == 0 and not loss.requires_grad


# --- make_dataset ---------------------------------------------------------


def test_make_dataset_features_equal_jax_sense_on_its_scene(monkeypatch):
    """The features make_dataset returns are JAX sense_classify's on the very
    scene it synthesized (captured as numpy)."""
    seen = {}
    synth = ttrain.synthesize_scene

    def capture(*args, **kw):
        out = synth(*args, **kw)
        seen["planes"] = out.numpy().copy()
        return out

    monkeypatch.setattr(ttrain, "synthesize_scene", capture)
    feats, labels = ttrain.make_dataset(torch.Generator().manual_seed(0), 24, device="cpu")
    assert feats.shape == (24, 4) and labels.shape == (24, 3)
    planes = seen["planes"].reshape(24, 10, 512, 2)
    jres = jax_sense_classify(jnp.asarray(planes), jax_reference_weights(), JaxSenseConfig())
    np.testing.assert_allclose(feats.numpy(), np.asarray(jres["features"]), rtol=1e-4)


@pytest.mark.parametrize("jitter", [1.5, 0.0])
def test_make_dataset_label_and_power_statistics(monkeypatch, jitter):
    """Each channel occupied with probability 0.35; the power of an occupied
    channel signal_power * 10**U(-j, j), one draw per example."""
    seen = {}
    synth = ttrain.synthesize_scene

    def capture(generator, powers, *args, **kw):
        seen["powers"] = powers.clone()
        return synth(generator, powers, *args, **kw)

    monkeypatch.setattr(ttrain, "synthesize_scene", capture)
    n = 400
    feats, labels = ttrain.make_dataset(torch.Generator().manual_seed(5), n, signal_power=0.05,
                                        power_jitter_decades=jitter, device="cpu")
    labels, powers = labels.numpy(), seen["powers"].numpy()
    assert set(np.unique(labels)) == {0.0, 1.0}
    # 1200 draws, standard deviation 0.0138: a bound of 5 of them (this seed's
    # draw sits 4.2 away; over 2000 seeds the deviations are unit normal)
    assert abs(labels.mean() - 0.35) < 5 * np.sqrt(0.35 * 0.65 / labels.size)
    assert (labels.sum(1) == 0).any() and (labels.sum(1) == 1).any() and (labels.sum(1) >= 2).any()
    np.testing.assert_array_equal(powers > 0, labels > 0)
    occupied = labels.sum(1) > 0
    ratio = powers[occupied].max(1) / 0.05
    # every occupied channel of an example gets that example's one power
    per_channel = powers[occupied] / 0.05
    counts = labels[occupied].sum(1).astype(int)
    np.testing.assert_allclose(per_channel[labels[occupied] > 0], np.repeat(ratio, counts), rtol=1e-6)
    dec = np.log10(ratio)
    if jitter:
        assert dec.min() >= -jitter - 1e-6 and dec.max() <= jitter + 1e-6
        assert dec.min() < -0.8 * jitter and dec.max() > 0.8 * jitter and abs(dec.mean()) < 0.3
    else:
        np.testing.assert_allclose(ratio, 1.0, rtol=1e-6)
    # an occupied channel's band feature stands above the idle ones at high power
    loud = powers[:, 0] >= 0.05 * (1 - 1e-6)
    assert feats[loud, 1].min() > feats[labels[:, 0] == 0, 1].max()


def test_make_dataset_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal with no card")
    with pytest.raises(RuntimeError, match="cuda is not available"):
        ttrain.make_dataset(torch.Generator(), 4)
    with pytest.raises(RuntimeError, match="cuda is not available"):
        ttrain.fit(torch.Generator(), np.ones((4, 4), np.float32), np.zeros((4, 3), np.float32))


# --- the reference's training criteria ------------------------------------


def test_fit_learns_synthetic_dataset():
    """tests/test_io_tools.py::TestTraining on the port's own draws."""
    feats, labels = ttrain.make_dataset(torch.Generator().manual_seed(0), 200, device="cpu")
    params, losses = ttrain.fit(torch.Generator().manual_seed(1), feats, labels,
                                ttrain.TrainConfig(num_steps=600, learning_rate=1e-2),
                                device="cpu")
    assert losses[-1] < losses[0] * 0.5
    with torch.no_grad():
        acc = float(((params(torch.log1p(feats)) > 0.5) == (labels > 0.5)).float().mean())
    assert acc > 0.9, f"accuracy {acc}"


def test_trained_matches_or_beats_reference_on_markov_trace():
    """tests/test_scenarios.py::test_trained_matches_or_beats_reference_on_markov_trace
    on the port, with the JAX package's arrays: its dataset (key(0), power
    0.005, jitter 2.5), start (key(1)), trace (key(42)) and scenes (key(8)).
    The port's fit and sense_classify score within one cycle in 256 of the
    JAX package's at every power, and meet the reference's criterion."""
    feats, labels = jtrain.make_dataset(
        jax.random.key(0), 400, signal_power=0.005, power_jitter_decades=2.5
    )
    feats, labels = np.array(feats), np.array(labels)
    start = _np(jax_init_mlp(jax.random.key(1)))
    jax_params, _ = jtrain.fit(jax.random.key(1), jnp.asarray(feats), jnp.asarray(labels),
                               jtrain.TrainConfig(num_steps=3000), params=_fresh(start))
    params, _ = ttrain.fit(None, feats, labels, ttrain.TrainConfig(num_steps=3000),
                           params=params_from_numpy(*start), device="cpu")
    jcfg = JaxSenseConfig()
    jcfg_t = dataclasses.replace(jcfg, feature_transform="log1p")
    cfg = SenseConfig()
    cfg_t = dataclasses.replace(cfg, feature_transform="log1p")
    trace = jax_markov_pu_trace(jax.random.key(42), 256)
    truth = np.asarray(trace) + 1
    syn = jax.jit(jax_synthesize_scene, static_argnums=(2,), static_argnames=("as_planes",))
    ref_w = reference_weights()
    for power in (0.05, 5e-3, 5e-4, 2e-4, 1e-4):
        powers = jax_occupancy_to_powers(trace, 3, power=power)
        iq = np.array(syn(jax.random.key(8), powers, cfg.samples_per_cycle, as_planes=True))
        iq = torch.from_numpy(iq.reshape(256, cfg.averaging, cfg.fft_length, 2))
        a_ref = float(np.mean(sense_classify(iq, ref_w, cfg)["decision"].numpy() == truth))
        a_tr = float(np.mean(sense_classify(iq, params, cfg_t)["decision"].numpy() == truth))
        j_tr = float(np.mean(np.asarray(
            jax_sense_classify(jnp.asarray(iq.numpy()), jax_params, jcfg_t)["decision"]) == truth))
        assert abs(a_tr - j_tr) <= 1 / 256, (power, a_tr, j_tr)
        assert a_tr >= a_ref - 1e-9, (power, a_ref, a_tr)
    assert a_tr >= 0.95 and a_ref <= 0.9, (a_ref, a_tr)


# --- training state across the packages -----------------------------------


def _jax_state(steps, jp, feats, labels, lr=3e-3):
    tcfg = jtrain.TrainConfig(learning_rate=lr)
    state = jtrain.TrainState(jp, optax.adam(lr).init(jp), jnp.int32(0))
    losses = []
    for _ in range(steps):
        state, loss = jtrain.train_step(state, jnp.asarray(feats), jnp.asarray(labels), tcfg)
        losses.append(float(loss))
    return state, np.array(losses)


def test_state_written_by_jax_loads_in_the_port(jax_data, tmp_path):
    feats, labels, jp = jax_data
    jstate, _ = _jax_state(7, jp, feats, labels)
    jax_save_state(tmp_path / "s.npz", jstate)
    like = _port_state(jax_init_mlp(jax.random.key(9)))
    got = load_state(tmp_path / "s.npz", like)
    assert got.step == 7 and got.params is like.params and got.opt is like.opt
    adam = jstate.opt_state[0]
    for name, want, mu, nu in zip(_NAMES, _np(jstate.params), _np(adam.mu), _np(adam.nu)):
        p = getattr(got.params, name)
        np.testing.assert_array_equal(p.detach().numpy(), want)
        st = got.opt.state[p]
        assert float(st["step"]) == 7.0 == int(adam.count)
        np.testing.assert_array_equal(st["exp_avg"].numpy(), mu)
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), nu)


def test_state_written_by_the_port_loads_in_jax(jax_data, tmp_path):
    feats, labels, jp = jax_data
    state = _port_state(jp)
    for _ in range(5):
        state, _ = ttrain.train_step(state, torch.from_numpy(feats), torch.from_numpy(labels),
                                     ttrain.TrainConfig())
    save_state(tmp_path / "s.npz", state)
    like = jtrain.TrainState(jp, optax.adam(3e-3).init(jp), jnp.int32(0))
    got = jax_load_state(tmp_path / "s.npz", like)
    assert int(got.step) == 5 and int(got.opt_state[0].count) == 5
    for name, value, mu, nu in zip(_NAMES, _np(got.params), _np(got.opt_state[0].mu),
                                   _np(got.opt_state[0].nu)):
        p = getattr(state.params, name)
        np.testing.assert_array_equal(value, p.detach().numpy())
        np.testing.assert_array_equal(mu, state.opt.state[p]["exp_avg"].numpy())
        np.testing.assert_array_equal(nu, state.opt.state[p]["exp_avg_sq"].numpy())


def test_state_before_any_step_has_zero_moments(tmp_path):
    state = _port_state(jax_init_mlp(jax.random.key(2)))
    save_state(tmp_path / "s.npz", state)
    with np.load(tmp_path / "s.npz") as d:
        assert int(d[".opt_state/[0]/.count"]) == 0 and int(d[".step"]) == 0
        assert d[".step"].dtype == np.int32 and d[".opt_state/[0]/.count"].dtype == np.int32
        assert not d[".opt_state/[0]/.mu/.w1"].any() and not d[".opt_state/[0]/.nu/.b2"].any()
    like = jtrain.TrainState(jax_init_mlp(jax.random.key(3)), optax.adam(3e-3).init(
        jax_init_mlp(jax.random.key(3))), jnp.int32(4))
    got = jax_load_state(tmp_path / "s.npz", like)
    np.testing.assert_array_equal(np.asarray(got.params.w1), state.params.w1.detach().numpy())


def test_training_resumed_across_the_packages_matches(jax_data, tmp_path):
    """50 JAX steps, save, then 50 more in each package from the file."""
    feats, labels, jp = jax_data
    start = _np(jp)
    jstate, _ = _jax_state(50, jp, feats, labels)
    jax_save_state(tmp_path / "s.npz", jstate)
    tcfg = jtrain.TrainConfig()
    want = []
    for _ in range(50):
        jstate, loss = jtrain.train_step(jstate, jnp.asarray(feats), jnp.asarray(labels), tcfg)
        want.append(float(loss))
    state = load_state(tmp_path / "s.npz", _port_state(_fresh(start)))
    got = []
    for _ in range(50):
        state, loss = ttrain.train_step(state, torch.from_numpy(feats), torch.from_numpy(labels),
                                        ttrain.TrainConfig())
        got.append(float(loss))
    assert state.step == int(jstate.step) == 100
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for g, w in zip(_np(state.params), _np(jstate.params)):
        np.testing.assert_allclose(g, w, atol=1e-4)


# --- deploy: checkpoint -> CE_Predictive_Node, and the train CLI -----------


def test_train_checkpoint_deploy_roundtrip(tmp_path):
    """tests/test_scenarios.py:134 on the port: train, checkpoint with the
    feature transform, load into CE_Predictive_Node via ``-w``; the SU still
    finds the parked PU on CH1 and retunes to 835 MHz."""
    feats, labels = ttrain.make_dataset(torch.Generator().manual_seed(0), 400, device="cpu")
    params, losses = ttrain.fit(torch.Generator().manual_seed(1), feats, labels,
                                ttrain.TrainConfig(num_steps=1500, learning_rate=3e-3),
                                device="cpu")
    assert losses[-1] < losses[0]
    ckpt = tmp_path / "mlp.npz"
    save_mlp(ckpt, params, feature_transform="log1p")
    _, meta = load_mlp_with_meta(ckpt)
    assert meta["feature_transform"] == "log1p"

    pu = trt.NodeConfig(cognitive_engine="CE_TX_CHANNEL_X", ce_args="-c 1", ce_timeout_ms=50.0,
                        net_mean_throughput=3e6, tx_freq=833e6, tx_rate=1.3e6, tx_gain=33.0,
                        rx_freq=870e6, rx_rate=1e6)
    su = trt.NodeConfig(cognitive_engine="CE_Predictive_Node", ce_args=f"-w {ckpt}",
                        ce_timeout_ms=10.0, net_mean_throughput=1e6, tx_freq=833e6,
                        tx_rate=1e6, tx_gain=25.0, rx_freq=833e6, rx_rate=13e6)
    cfg = trt.ScenarioConfig(num_nodes=2, run_time=0.45, nodes=[pu, su], medium_rate=13e6,
                             medium_center=833e6, medium_block_len=65536,
                             medium_noise_power=1e-7, name="predictive_test")
    rt = trt.ScenarioRuntime(cfg, device="cpu")
    rt.run()
    eng = rt.nodes[1].engine
    assert not rt.failed_nodes
    assert eng.cfg.feature_transform == "log1p"
    assert len(eng.decisions) >= 2
    assert eng.decisions[-1] == 1, eng.decisions
    assert rt.nodes[1].radio.get_tx_freq() == 835e6


def _cli(*args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "cognitive_radio_network_tpu_torch", *args],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )


def test_train_cli_writes_a_checkpoint_jax_reads(tmp_path):
    out = tmp_path / "ck" / "mlp.npz"
    proc = _cli("train", "-n", "64", "-s", "50", "--device", "cpu", "-o", str(out), cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("trained 64 examples, 50 steps: loss ")
    assert f"saved {out}" in proc.stdout
    params, meta = jax_load_mlp_with_meta(out)
    assert meta["feature_transform"] == "log1p"
    assert np.asarray(params.w1).shape == (4, 5) and np.asarray(params.b2).shape == (3,)
    port, port_meta = load_mlp_with_meta(out)
    assert port_meta == meta
    for a, b in zip(_np(port), _np(params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.skipif("torch.cuda.is_available()", reason="checks the refusal with no card")
def test_train_cli_defaults_to_the_card_and_refuses_without_one(tmp_path):
    for args in (("train", "-n", "8", "-s", "2"), ("train", "-n", "8", "-s", "2", "--device", "cuda")):
        proc = _cli(*args, "-o", str(tmp_path / "x.npz"), cwd=tmp_path)
        assert proc.returncode != 0 and "device cuda is not available" in proc.stderr
    assert not (tmp_path / "x.npz").exists()
