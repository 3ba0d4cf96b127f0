"""Port vs JAX package: the runtime's host layers (config, stats, traffic,
logging, medium, registries), the CLI's runtime subcommands, and the rule
that entry points run on the card unless asked for the CPU.

The host layers are numpy in both packages, so the same inputs must give
equal outputs.  One divergence is deliberate: a complex gain uniform across
a cell keeps its phase in the port's medium (the reference drops it)."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cognitive_radio_network_tpu import runtime as jrt
from cognitive_radio_network_tpu.runtime import logging as jlog
from cognitive_radio_network_tpu.runtime import medium as jmed
from cognitive_radio_network_tpu.runtime import stats as jstats
from cognitive_radio_network_tpu_torch import runtime as trt
from cognitive_radio_network_tpu_torch.runtime import logging as tlog
from cognitive_radio_network_tpu_torch.runtime import medium as tmed
from cognitive_radio_network_tpu_torch.runtime import stats as tstats

ROOT = Path(__file__).resolve().parents[1]
SCENARIOS = sorted((ROOT / "scenarios").glob("*.cfg"))


# ---------------------------------------------------------------- config


@pytest.mark.parametrize("path", [p for p in SCENARIOS if "master" not in p.name],
                         ids=lambda p: p.stem)
def test_load_scenario_equal(path):
    got, want = trt.load_scenario(path), jrt.load_scenario(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.phy_placement == want.phy_placement


def test_load_master_equal():
    path = ROOT / "scenarios" / "scenario_master_template.cfg"
    assert dataclasses.asdict(trt.load_master(path)) == dataclasses.asdict(jrt.load_master(path))


def test_parse_cfg_groups_allocs_and_placement_equal():
    text = """
    // comment
    num_nodes = 2; run_time = 1.5; phy_placement = "device"; seed = 7;
    node1 : { node_type = "interferer"; tx_freq = 833e6; CE = "CE_Template";
              tx_subcarrier_alloc_method = "custom";
              tx_subcarrier_alloc : { sc_type_1 = "null"; sc_num_1 = 4;
                                      sc_type_2 = "data"; sc_num_2 = 24;
                                      sc_type_3 = "null"; sc_num_3 = 4; }; };
    node2 : { tx_gain = 25; generate_octave_log_file = 1; };
    """
    assert trt.parse_cfg(text) == jrt.parse_cfg(text)
    got = trt.scenario_from_dict(trt.parse_cfg(text))
    want = jrt.scenario_from_dict(jrt.parse_cfg(text))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.phy_placement == "device" and got.nodes[0].tx_subcarrier_alloc[1] == ("data", 24)


# ----------------------------------------------------------- stats, traffic


def test_rx_statistics_equal():
    rng = np.random.default_rng(2)
    got, want = tstats.RxStatistics(0.5), jstats.RxStatistics(0.5)
    for k in range(60):
        payload = None if k % 7 == 3 else want.known_payload.copy()
        if payload is not None and k % 5 == 0:
            payload[rng.integers(4, 256)] ^= np.uint8(1 << int(rng.integers(0, 8)))
        args = (k * 0.03, bool(k % 4), float(rng.uniform(-30, -5)), float(rng.uniform(-60, -20)),
                payload)
        got.record_frame(*args)
        want.record_frame(*args)
        if k % 9 == 0:
            got.record_overflow()
            want.record_overflow()
        if k % 10 == 9:
            assert dataclasses.asdict(got.snapshot(k * 0.03)) == dataclasses.asdict(
                want.snapshot(k * 0.03))
    got.reset()
    want.reset()
    assert dataclasses.asdict(got.snapshot(5.0)) == dataclasses.asdict(want.snapshot(5.0))


@pytest.mark.parametrize("kind,burst", [("stream", 1), ("burst", 3), ("poisson", 1)])
def test_traffic_equal(kind, burst):
    got = trt.TrafficSource(trt.TrafficConfig(kind, 2048e3, burst), seed=5)
    want = jrt.TrafficSource(jrt.TrafficConfig(kind, 2048e3, burst), seed=5)
    for t in (0.0, 0.013, 0.05, 0.2):
        a, b = got.packets_until(t), want.packets_until(t)
        assert [ts for ts, _ in a] == [ts for ts, _ in b]
        for (_, pa), (_, pb) in zip(a, b):
            np.testing.assert_array_equal(pa, pb)
    assert got.packet_num == want.packet_num > 100
    assert trt.TrafficSource.packet_number(a[-1][1]) == got.packet_num - 1


# ----------------------------------------------------------------- logging


class _Stats:  # the FrameSyncStats fields a log record reads
    evm, rssi, cfo, num_framesyms = -21.5, -40.25, 0.001, 12
    mod_scheme, check, fec0, fec1 = "qam4", "crc32", "h128", "none"


def _fill(sink, pkg):
    from types import SimpleNamespace

    m = SimpleNamespace(time_s=0.25, frame_num=9, frame_type=0, header_valid=True,
                        payload_valid=False, stats=_Stats())
    sink.log_phy_rx(1, m)
    sink.log_phy_tx(0, 3, dataclasses.asdict(pkg.RadioParams()))
    pkt = np.arange(256, dtype=np.uint8)
    sink.log_net_tx(0, 0.125, pkt)
    sink.log_net_rx(1, 0.5, pkt)
    sink.log_int_tx(2, 0.75, 459.5e6)


def test_log_sink_exports_equal(tmp_path):
    from cognitive_radio_network_tpu.runtime import radio as jradio
    from cognitive_radio_network_tpu_torch.runtime import radio as tradio

    got, want = tlog.LogSink({"log_net_rx": False}), jlog.LogSink({"log_net_rx": False})
    _fill(got, tradio)
    _fill(want, jradio)
    for name in ("phy_rx", "phy_tx", "net_rx", "net_tx", "int_tx"):
        assert getattr(got, name) == getattr(want, name), name
    got.save_npz(tmp_path / "t.npz")
    want.save_npz(tmp_path / "j.npz")
    with np.load(tmp_path / "t.npz") as a, np.load(tmp_path / "j.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    got.export_octave(tmp_path / "t.m")
    want.export_octave(tmp_path / "j.m")
    assert (tmp_path / "t.m").read_text() == (tmp_path / "j.m").read_text()


def test_binary_logs_name_the_missing_native_loader(tmp_path):
    with pytest.raises(NotImplementedError, match="native/ loader"):
        tlog.LogSink(spill_dir=tmp_path)
    with pytest.raises(NotImplementedError, match="native/ loader"):
        tlog.read_binlog(tmp_path / "phy_rx.crnl")
    assert tlog.BINLOG_SCHEMAS == jlog.BINLOG_SCHEMAS


# ------------------------------------------------------------------ medium


def _blocks(rng, n, block, silent=()):
    return [None if j in silent else (rng.standard_normal(block) + 1j * rng.standard_normal(block))
            .astype(np.complex64) for j in range(n)]


def _celled(n, cells):
    g = np.zeros((n, n), np.float32)
    for s, size, v in cells:
        g[s : s + size, s : s + size] = v
    return g


GAINS = {
    "all_ones": lambda: None,
    "uniform_half": lambda: np.full((5, 5), 0.5, np.float32),
    "celled": lambda: _celled(9, [(0, 3, 1.0), (3, 3, 0.25), (6, 3, 2.0)]),
    "nonuniform_gemm": lambda: np.array(
        [[0, 1, 0.5, 0], [1, 0, 0.2, 0], [0.5, 0.2, 0, 0], [0, 0, 0, 0]], np.float32),
}


@pytest.mark.parametrize("name", sorted(GAINS))
@pytest.mark.parametrize("silent", [(), (1,), (0, 2)], ids=["all_on", "one_off", "two_off"])
def test_medium_propagate_equal_for_real_gains(name, silent):
    g = GAINS[name]()
    n = 5 if g is None else g.shape[0]
    contr = _blocks(np.random.default_rng(n), n, 512, silent)
    got = tmed.Medium(tmed.MediumConfig(block_len=512), n, None if g is None else g.copy())
    want = jmed.Medium(jmed.MediumConfig(block_len=512), n, None if g is None else g.copy())
    for a, b in zip(got.propagate(contr), want.propagate(contr)):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype == np.complex64
            np.testing.assert_array_equal(a, b)


def test_complex_cell_gain_keeps_its_phase():
    """Reference fault 1 (cognitive_radio_network_tpu/runtime/medium.py:151):
    a gain of 1j uniform across a cell reaches the port's receivers rotated
    by 90 degrees; the reference's float() keeps the real part, 0, and the
    receivers hear nothing.  This is a declared divergence."""
    n, block = 3, 256
    contr = _blocks(np.random.default_rng(0), n, block, silent=(1, 2))
    gains = np.full((n, n), 1j, np.complex64)
    got = tmed.Medium(tmed.MediumConfig(block_len=block), n, gains.copy())
    assert got._gain_cells() is not None  # the cell fast path, not the GEMM
    heard = got.propagate(contr)
    assert heard[0] is None  # a node does not hear itself
    for i in (1, 2):
        assert heard[i].dtype == np.complex64
        np.testing.assert_allclose(heard[i], 1j * contr[0], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(np.angle(np.vdot(contr[0], heard[i])), np.pi / 2, atol=1e-6)
    # the divergence: the reference silences the cell
    want = jmed.Medium(jmed.MediumConfig(block_len=block), n, gains.copy())
    with pytest.warns(np.exceptions.ComplexWarning):
        silenced = want.propagate(contr)
    assert silenced == [None, None, None]
    # a phase-bearing gain whose receivers hear two transmitters: the sum
    # less the receiver's own contribution, rotated
    contr2 = _blocks(np.random.default_rng(1), n, block, silent=(2,))
    g = np.complex64(0.6 - 0.8j)
    heard2 = tmed.Medium(tmed.MediumConfig(block_len=block), n, np.full((n, n), g)).propagate(
        contr2)
    np.testing.assert_allclose(heard2[0], g * contr2[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(heard2[2], g * (contr2[0] + contr2[1]), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- registries, nodes


def test_registries_list_the_reference_names_and_stay_apart():
    from cognitive_radio_network_tpu.runtime import engine as jeng
    from cognitive_radio_network_tpu_torch.runtime import engine as teng

    assert trt.engine_names() == jrt.engine_names()
    assert trt.controller_names() == jrt.controller_names()
    for reg in (teng._ENGINES, teng._CONTROLLERS):
        assert all(c.__module__.startswith("cognitive_radio_network_tpu_torch.") for c in reg.values())
    for reg in (jeng._ENGINES, jeng._CONTROLLERS):
        assert not any(c.__module__.startswith("cognitive_radio_network_tpu_torch") for c in reg.values())


def _link_cfg(pkg, run_time=0.05):
    common = dict(tx_rate=1e6, rx_rate=1e6, tx_gain_soft=-6.0, net_mean_throughput=200e3)
    return pkg.ScenarioConfig(
        num_nodes=2, run_time=run_time, medium_rate=4e6, medium_center=465e6,
        medium_block_len=16384, medium_noise_power=1e-7, name="two_node_link",
        nodes=[pkg.NodeConfig(tx_freq=464e6, rx_freq=466e6, **common),
               pkg.NodeConfig(tx_freq=466e6, rx_freq=464e6, **common)],
    )


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the default device with no card")
def test_default_device_is_the_card_and_raises_without_one():
    """No CPU fallback: with no card, the default device raises before any
    node is built or a step is taken."""
    from cognitive_radio_network_tpu_torch.runtime.control import build_node
    from cognitive_radio_network_tpu_torch.runtime.node import InterfererNode, RadioNode
    from cognitive_radio_network_tpu_torch.runtime.radio import Radio

    ran = []
    cfg = _link_cfg(trt)
    with pytest.raises(RuntimeError, match="not available"):
        rt = trt.ScenarioRuntime(cfg)
        ran.append(rt.run())
    assert not ran
    with pytest.raises(RuntimeError, match="not available"):
        trt.run_master(trt.MasterConfig(scenarios=[("x", 1)]), lambda name: _link_cfg(trt))
    mcfg = tmed.MediumConfig()
    for make in (
        lambda: Radio(4e6, 465e6),
        lambda: RadioNode(0, 4e6, 465e6),
        lambda: InterfererNode(0, 4e6, 465e6, None),
        lambda: build_node(0, cfg.nodes[0], mcfg, None),
    ):
        with pytest.raises(RuntimeError, match="not available"):
            make()
    rt = trt.ScenarioRuntime(cfg, device="cpu")
    assert rt.device.type == "cpu" and all(n.radio.device.type == "cpu" for n in rt.nodes)


def test_phy_placement_host_runs_on_the_callers_device():
    cfg = _link_cfg(trt)
    assert cfg.phy_placement == "host"
    rt = trt.ScenarioRuntime(cfg, device="cpu")
    rt.run()
    assert not rt.failed_nodes
    assert all(n.radio._rx.device.type == "cpu" for n in rt.nodes)


def test_process_radio_names_the_missing_module():
    from cognitive_radio_network_tpu_torch.runtime.control import build_node

    nc = trt.NodeConfig(cognitive_radio_type="python-process", python_file="radio.py")
    with pytest.raises(NotImplementedError, match="procradio"):
        build_node(0, nc, tmed.MediumConfig(), None, device="cpu")


def test_control_and_feedback_apply_like_the_reference():
    from cognitive_radio_network_tpu_torch.runtime.control import FB_GETTERS

    from cognitive_radio_network_tpu.runtime.control import FB_GETTERS as J_FB_GETTERS

    rt = trt.ScenarioRuntime(_link_cfg(trt), device="cpu")
    jr = jrt.ScenarioRuntime(_link_cfg(jrt))
    for pkg, r in ((trt, rt), (jrt, jr)):
        r.start()
        r.apply_control(0, pkg.CrtsParam.TX_FREQ, 470e6)
        r.apply_control(0, pkg.CrtsParam.TX_MOD, "qam16")
        r.apply_control(1, pkg.CrtsParam.RX_STATE, 0)
        r.apply_control(1, pkg.CrtsParam.FB_EN, 0b11)
    assert [p.name for p in FB_GETTERS] == [p.name for p in J_FB_GETTERS]
    for i in (0, 1):
        for param, getter in FB_GETTERS.items():
            want = J_FB_GETTERS[jrt.CrtsParam[param.name]](jr.nodes[i].radio)
            assert getter(rt.nodes[i].radio) == want, (i, param)
    assert rt.nodes[0].radio.get_tx_freq() == 470e6
    assert rt.sc.get_feedback_enables(1) == jr.sc.get_feedback_enables(1) == 0b11


# --------------------------------------------------------------------- CLI


def _cli(*args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "cognitive_radio_network_tpu_torch", *args],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )


def test_cli_engines_lists_the_reference_names(tmp_path):
    proc = _cli("engines", cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines == [
        "cognitive engines: " + ", ".join(jrt.engine_names()),
        "scenario controllers: " + ", ".join(jrt.controller_names()),
    ]


def test_cli_scenario_on_the_cpu_prints_the_summary(tmp_path):
    cfg = ROOT / "scenarios" / "predictive_model.cfg"
    proc = _cli("scenario", str(cfg), "-t", "0.1", "--device", "cpu", "-l", str(tmp_path / "logs"),
                cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("predictive_model rep 1: bytes_sent=[")
    assert (tmp_path / "logs" / "predictive_model_rep1.npz").exists()
    assert (tmp_path / "logs" / "octave" / "summary.m").exists()
    # the default device is the card: with none, the command fails, nothing runs
    proc = _cli("scenario", str(cfg), "-t", "0.1", "-l", str(tmp_path / "cuda_logs"), cwd=tmp_path)
    assert proc.returncode != 0 and "not available" in proc.stderr
    assert not (tmp_path / "cuda_logs").exists()


def test_cli_scenario_exits_nonzero_when_a_node_fails(tmp_path, monkeypatch, capsys):
    """A node halted by the controller's isolation boundary (a kernel that
    fails inside a step lands there) is reported, and the command fails."""
    from cognitive_radio_network_tpu_torch import __main__ as cli
    from cognitive_radio_network_tpu_torch.runtime.node import RadioNode

    def broken(self, t):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(RadioNode, "run_ce", broken)
    runs = trt.run_master(trt.MasterConfig(scenarios=[("x", 1)]),
                          lambda name: _link_cfg(trt, run_time=0.01), device="cpu")
    assert [sorted(failed) for _, failed in runs] == [[0, 1]]
    assert "launch failed" in runs[0][1][0]
    cfg = ROOT / "scenarios" / "predictive_model.cfg"
    rc = cli.main(["scenario", str(cfg), "-t", "0.01", "--device", "cpu", "-l",
                   str(tmp_path / "logs")])
    out = capsys.readouterr()
    assert rc != 0
    assert out.out.startswith("predictive_model rep 1: bytes_sent=[")
    assert "node 0 failed: RuntimeError: launch failed" in out.err


def test_cli_master_runs_each_listed_scenario(tmp_path):
    text = (ROOT / "scenarios" / "predictive_model.cfg").read_text()
    (tmp_path / "short.cfg").write_text(text.replace("run_time = 20.0;", "run_time = 0.05;"))
    (tmp_path / "master.cfg").write_text(
        'num_scenarios = 1; reps_all_scenarios = 2; octave_log_summary = true;\n'
        'scenario_1 : { name = "short"; };\n')
    proc = _cli("master", str(tmp_path / "master.cfg"), "--device", "cpu", "-l",
                str(tmp_path / "logs"), cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert [ln.split(":")[0] for ln in proc.stdout.splitlines()] == ["short rep 1", "short rep 2"]
    summary = (tmp_path / "logs" / "octave" / "summary.m").read_text()
    assert "bytes_sent_short_rep2 = [" in summary
