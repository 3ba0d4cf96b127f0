"""Port vs JAX package: whole scenarios through ``ScenarioRuntime``.

Without interferers every random draw of a scenario is numpy in both
packages (the medium, the receiver noise pool, the traffic m-sequence, the
random PU), so the port on the CPU must give the JAX runtime's
``ScenarioSummary``, packets and engine decisions exactly.  Scenarios run at
the reference tests' own run times (0.25-0.45 s)."""

import dataclasses
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from cognitive_radio_network_tpu import runtime as jrt
from cognitive_radio_network_tpu_torch import runtime as trt

ROOT = Path(__file__).resolve().parents[1]


def _link_scenario(pkg, run_time=0.25):
    """tests/test_runtime.py::_link_scenario: two nodes, FDD, 1 MS/s each
    way inside a 4 MHz medium."""
    common = dict(tx_rate=1e6, rx_rate=1e6, tx_gain=20.0, rx_gain=20.0, tx_gain_soft=-6.0,
                  ce_timeout_ms=1000.0)
    return pkg.ScenarioConfig(
        num_nodes=2, run_time=run_time,
        nodes=[pkg.NodeConfig(net_mean_throughput=200e3, tx_freq=464e6, rx_freq=466e6, **common),
               pkg.NodeConfig(net_mean_throughput=200e3, tx_freq=466e6, rx_freq=464e6, **common)],
        medium_rate=4e6, medium_center=465e6, medium_block_len=16384, medium_noise_power=1e-7,
        name="two_node_link",
    )


def _predictive_scenario(pkg, run_time=0.45, pu_engine="CE_TX_CHANNEL_X", pu_args="-c 1",
                         su_args=""):
    """tests/test_scenarios.py::_predictive_scenario: a PU parked on a
    channel and the CE_Predictive_Node SU sensing 833 MHz at 13 MS/s."""
    pu = pkg.NodeConfig(cognitive_engine=pu_engine, ce_args=pu_args, ce_timeout_ms=50.0,
                        net_mean_throughput=3e6, tx_freq=833e6, tx_rate=1.3e6, tx_gain=33.0,
                        rx_freq=870e6, rx_rate=1e6)
    su = pkg.NodeConfig(cognitive_engine="CE_Predictive_Node", ce_args=su_args,
                        ce_timeout_ms=10.0, net_mean_throughput=1e6, tx_freq=833e6,
                        tx_rate=1e6, tx_gain=25.0, rx_freq=833e6, rx_rate=13e6)
    return pkg.ScenarioConfig(num_nodes=2, run_time=run_time, nodes=[pu, su], medium_rate=13e6,
                              medium_center=833e6, medium_block_len=65536,
                              medium_noise_power=1e-7, name="predictive_test")


def _run_both(make):
    port = trt.ScenarioRuntime(make(trt), device="cpu")
    ref = jrt.ScenarioRuntime(make(jrt))
    return (port, port.run()), (ref, ref.run())


@pytest.fixture(scope="module")
def link_runs():
    return _run_both(_link_scenario)


def test_link_summary_equals_jax(link_runs):
    (port, got), (ref, want) = link_runs
    assert not port.failed_nodes and not ref.failed_nodes
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert min(got.valid_frames) >= 20 and min(got.bytes_received) > 0


@pytest.mark.parametrize("node", [0, 1])
def test_link_packets_equal_jax(link_runs, node):
    (port, _), (ref, _) = link_runs
    got, want = port.nodes[node].rx_packets, ref.nodes[node].rx_packets
    assert [(t, n) for t, n, _ in got] == [(t, n) for t, n, _ in want]
    known = trt.TrafficSource(trt.TrafficConfig()).base_payload
    for (_, _, a), (_, _, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a[4:], known[4:])
    gs, ws = port.nodes[node].radio.get_rx_stats(port.t), ref.nodes[node].radio.get_rx_stats(ref.t)
    assert (gs.frames_received, gs.valid_frames, gs.per, gs.ber_uncoded) == (
        ws.frames_received, ws.valid_frames, ws.per, ws.ber_uncoded)
    assert port.nodes[node].radio.num_tx_frames == ref.nodes[node].radio.num_tx_frames


@pytest.mark.parametrize("channel,decision", [(1, 1), (3, 3)])
def test_predictive_decisions_equal_jax(channel, decision):
    """CE_TX_CHANNEL_X parks the PU on a channel; the SU's decision list
    equals the reference's, its dominant decision names that channel and
    its tx retunes to CH2 = 835 MHz (CE_Predictive_Node.cpp:245-258)."""
    (port, got), (ref, want) = _run_both(
        lambda pkg: _predictive_scenario(pkg, pu_args=f"-c {channel}"))
    assert not port.failed_nodes
    g_eng, w_eng = port.nodes[1].engine, ref.nodes[1].engine
    assert len(g_eng.decisions) >= 2
    assert g_eng.decisions == w_eng.decisions
    assert Counter(g_eng.decisions).most_common(1)[0][0] == decision
    assert port.nodes[1].radio.get_tx_freq() == ref.nodes[1].radio.get_tx_freq() == 835e6
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for a, b in zip(g_eng.outputs, w_eng.outputs):  # MLP outputs, f32 rounding apart
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5)


def test_predictive_model_cfg_runs():
    """tests/test_tpu_gates.py::test_scenario_nodes_survive_ambient_backend
    on the port: the shipped predictive scenario at 0.4 s keeps every node
    alive and the SU decides."""
    cfg = trt.load_scenario(ROOT / "scenarios" / "predictive_model.cfg")
    cfg.run_time = 0.4
    rt = trt.ScenarioRuntime(cfg, device="cpu")
    summary = rt.run()
    assert not rt.failed_nodes, rt.failed_nodes
    assert len(rt.nodes[1].engine.decisions) > 0
    assert summary.bytes_sent[0] > 0  # the random PU transmits at 1.4 MS/s (65/7)


def test_jax_checkpoint_through_w_gives_jax_decisions(tmp_path):
    """A checkpoint written by the JAX package's save_mlp, loaded through
    ``-w``: the same decisions as the JAX runtime with the same file."""
    import jax.numpy as jnp

    from cognitive_radio_network_tpu.io.checkpoint import save_mlp
    from cognitive_radio_network_tpu.signal.mlp import reference_weights

    params = reference_weights()
    # perturbed so the checkpoint is not the engine's default weights
    params = params._replace(w2=jnp.asarray(params.w2) * 1.05, b2=jnp.asarray(params.b2) - 0.1)
    ckpt = tmp_path / "mlp.npz"
    save_mlp(ckpt, params, feature_transform="none")
    (port, _), (ref, _) = _run_both(
        lambda pkg: _predictive_scenario(pkg, run_time=0.35, pu_args="-c 2", su_args=f"-w {ckpt}"))
    assert not port.failed_nodes
    g_eng, w_eng = port.nodes[1].engine, ref.nodes[1].engine
    assert g_eng.cfg.feature_transform == "none"
    assert len(g_eng.decisions) >= 2
    assert g_eng.decisions == w_eng.decisions
    assert port.nodes[1].radio.get_tx_freq() == ref.nodes[1].radio.get_tx_freq()


def test_cw_interferer_drives_decision_2():
    """tests/test_scenarios.py::test_cw_interferer_occupies_band on the
    port: a CW interferer at 835 MHz makes the SU find CH2 occupied."""
    cfg = _predictive_scenario(trt, run_time=0.35)
    cfg.nodes[0] = trt.NodeConfig(node_type="interferer", interference_type="cw", period=1.0,
                                  duty_cycle=1.0, tx_freq=835e6, tx_rate=1e6, tx_gain_soft=18.0)
    rt = trt.ScenarioRuntime(cfg, device="cpu")
    rt.run()
    eng = rt.nodes[1].engine
    assert len(eng.decisions) >= 2
    assert Counter(eng.decisions).most_common(1)[0][0] == 2, eng.decisions


def test_eight_node_cfg_pairs_deliver():
    """scenarios/eight_node.cfg (three FDD pairs, a gated CW and a sweeping
    noise interferer, 16 MS/s medium) at a short run time: every radio
    receives intact packets and no node fails."""
    cfg = trt.load_scenario(ROOT / "scenarios" / "eight_node.cfg")
    cfg.run_time = 0.1
    rt = trt.ScenarioRuntime(cfg, device="cpu")
    summary = rt.run()
    assert not rt.failed_nodes, rt.failed_nodes
    known = trt.TrafficSource(trt.TrafficConfig()).base_payload
    for i in range(6):
        assert summary.bytes_received[i] > 0, (i, summary)
        for _, _, p in rt.nodes[i].rx_packets:
            np.testing.assert_array_equal(p[4:], known[4:])
    assert summary.bytes_sent[6:] == [0, 0]
