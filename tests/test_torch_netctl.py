"""The port's multi-process networked runtime (runtime/netctl.py) against
tests/test_netctl.py's checks, and against the JAX package.

Covers: the wire format, across packages (the port's PyMsgTransport against
the JAX package's native and Python transports, in both directions); the
controller <-> node-process protocol with real OS subprocesses
(SCENARIO_PARAMETERS -> START -> lockstep TX/RX blocks -> CONTROL/FEEDBACK
-> TERMINATE -> SUMMARY), whose ScenarioSummary must equal the port's and the
JAX package's in-process runs on the same seeded lockstep medium, pipelined
and serial; SC control and feedback; interferer nodes; a crashing node; the
no-card rule.  Every run is on ``device="cpu"``, with short accept and step
timeouts.  TCP ports 47710-47749 are this file's."""

import dataclasses
import json
import math
import struct
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from cognitive_radio_network_tpu import native as jnative
from cognitive_radio_network_tpu import runtime as jrt
from cognitive_radio_network_tpu.runtime import netctl as jnet
from cognitive_radio_network_tpu_torch import native
from cognitive_radio_network_tpu_torch import runtime as trt
from cognitive_radio_network_tpu_torch.runtime import NodeConfig, ScenarioConfig, ScenarioRuntime
from cognitive_radio_network_tpu_torch.runtime.netctl import (
    Msg,
    NetController,
    PyMsgTransport,
    _fit_recv_cap,
    _pack_block,
    _scenario_from_asdict,
    _unpack_block,
    get_transport,
    run_node_client,
)

ROOT = Path(__file__).resolve().parents[1]
KERNELS = {"fused_sense_ct", "extract_windows", "wideband_energy_fused", "fused_band_features",
           "resolve_candidates"}


def _two_node_scenario(pkg=trt, run_time=0.1):
    """Two OFDM radios on an FDD link over the medium (tests/test_netctl.py's
    shape), small enough for subprocess tests, in ``pkg``'s config classes."""
    common = dict(cognitive_engine="CE_Template", ce_timeout_ms=1000.0,
                  net_mean_throughput=200e3, tx_rate=1e6, rx_rate=1e6, tx_gain=20.0,
                  rx_gain=20.0, tx_gain_soft=-6.0)
    cfg = pkg.ScenarioConfig(
        num_nodes=2, run_time=run_time,
        nodes=[pkg.NodeConfig(tx_freq=464e6, rx_freq=466e6, **common),
               pkg.NodeConfig(tx_freq=466e6, rx_freq=464e6, **common)],
        medium_rate=4e6, medium_center=465e6, medium_block_len=16384,
        medium_noise_power=1e-7, seed=3, name="netctl_test",
    )
    cfg.net_step_timeout_s = 30.0
    return cfg


def _controller(cfg, port, transport="python", **kw):
    kw.setdefault("accept_timeout_s", 60.0)
    return NetController(cfg, port=port, transport=transport, start_pad_s=0.1, device="cpu",
                         **kw)


# ---------------------------------------------------------------- the wire


class TestBlockPacking:
    def test_roundtrip_and_equal_to_jax(self, rng):
        block = (rng.standard_normal(256) + 1j * rng.standard_normal(256)).astype(np.complex64)
        assert _pack_block(7, block) == jnet._pack_block(7, block)
        step, out = _unpack_block(_pack_block(7, block))
        assert step == 7
        np.testing.assert_array_equal(out, block)

    def test_none_block(self):
        assert _pack_block(3, None) == jnet._pack_block(3, None)
        step, out = _unpack_block(_pack_block(3, None))
        assert step == 3 and out is None

    def test_scenario_config_crosses_the_wire(self):
        cfg = _two_node_scenario()
        cfg.nodes[1].ce_args = "-c 1"
        d = json.loads(json.dumps(dataclasses.asdict(cfg)))
        assert dataclasses.asdict(_scenario_from_asdict(d)) == dataclasses.asdict(cfg)
        jd = json.loads(json.dumps(dataclasses.asdict(_two_node_scenario(jrt))))
        assert dataclasses.asdict(_scenario_from_asdict(jd)) == dataclasses.asdict(
            _two_node_scenario())

    def test_recv_cap_fits_a_block(self):
        class Conn:
            cap = 0

            def set_recv_cap(self, cap):
                self.cap = cap

        c = Conn()
        _fit_recv_cap(c, 65536)
        assert c.cap >= 4 + 8 * 65536
        _fit_recv_cap(object(), 65536)  # PyMsgTransport has no cap


# the JAX package's two transports; the port's PyMsgTransport speaks to each
_PEERS = {"jax-native": jnative.MsgTransport, "jax-python": jnet.PyMsgTransport,
          "port-native": native.MsgTransport}


@pytest.mark.parametrize("port_side", ["client", "server"])
@pytest.mark.parametrize("peer", sorted(_PEERS))
def test_transport_interop(peer, port_side, rng):
    """A control message, a scatter-gathered block and an empty message each
    way between the port's PyMsgTransport and ``peer``."""
    tcp = 47710 + 2 * sorted(_PEERS).index(peer) + (port_side == "server")
    server_cls, client_cls = (
        (_PEERS[peer], PyMsgTransport) if port_side == "client" else (PyMsgTransport, _PEERS[peer]))
    block = (rng.standard_normal(70000) + 1j * rng.standard_normal(70000)).astype(np.complex64)
    srv = server_cls.listen(tcp)
    got = {}

    def server():
        conn = server_cls.accept(srv, 5000)
        _fit_recv_cap(conn, len(block))
        got["ctl"] = conn.recv(5000)
        got["blk"] = conn.recv(5000)
        conn.send2(Msg.RX_BLOCK, struct.pack("<I", 5), block)
        conn.send(Msg.TERMINATE)
        got["timeout"] = conn.recv(50)
        conn.close()

    t = threading.Thread(target=server)
    t.start()
    try:
        cli = client_cls.connect("127.0.0.1", tcp, 5000)
        _fit_recv_cap(cli, len(block))
        cli.send(Msg.CONTROL, json.dumps({"param": 1, "value": 2.5}).encode())
        cli.send2(Msg.TX_BLOCK, struct.pack("<I", 11), block)
        typ, payload = cli.recv(5000)
        assert (typ, _unpack_block(payload)[0]) == (Msg.RX_BLOCK, 5)
        np.testing.assert_array_equal(_unpack_block(payload)[1], block)
        assert cli.recv(5000) == (Msg.TERMINATE, b"")
        t.join(10)
        assert not t.is_alive()
        cli.close()
    finally:
        server_cls.close_server(srv)
    assert got["ctl"] == (Msg.CONTROL, b'{"param": 1, "value": 2.5}')
    assert got["blk"] == (Msg.TX_BLOCK, _pack_block(11, block))
    assert got["timeout"] is None


def test_get_transport_selection(monkeypatch):
    assert get_transport("python") is PyMsgTransport
    assert get_transport("native") is native.MsgTransport
    assert get_transport("auto") is native.MsgTransport  # the library builds here
    monkeypatch.setattr(native, "load", lambda: None)  # a host where it does not
    assert get_transport("auto") is PyMsgTransport
    with pytest.raises(RuntimeError, match="native runtime library unavailable"):
        get_transport("native").listen(47730)


# --------------------------------------------------- distributed scenarios


@pytest.fixture(scope="module")
def inprocess():
    """The two-node scenario in this process: the port's runtime and the
    JAX package's."""
    port = ScenarioRuntime(_two_node_scenario(), device="cpu").run()
    ref = jrt.ScenarioRuntime(_two_node_scenario(jrt)).run()
    return port, ref


@pytest.mark.parametrize(
    "pipeline,transport,tcp", [(True, "python", 47731), (False, "python", 47732),
                               (True, "native", 47733)],
    ids=["pipelined-python", "serial-python", "pipelined-native"])
def test_distributed_run_matches_inprocess(inprocess, pipeline, transport, tcp):
    """One OS process per node; the same seeded medium, lockstep: the
    summary equals the port's in-process run and the JAX package's.
    ``net_pipeline=False`` is the strictly serial loop."""
    cfg = _two_node_scenario()
    cfg.net_pipeline = pipeline
    ctl = _controller(cfg, tcp, transport)
    dist = ctl.run()
    port, ref = inprocess
    assert dataclasses.asdict(dist) == dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert sum(dist.valid_frames) > 0, "no frames crossed the medium"
    steps = math.ceil(cfg.run_time / (cfg.medium_block_len / cfg.medium_rate) - 1e-9)
    for i in range(2):
        s = ctl.summaries[i]
        assert s["tx_samples"] == steps * cfg.medium_block_len
        assert s["cpu_time_s"] > 0 and s["sim_time_s"] > 0
        # the kernels' counters: the plain versions ran on the CPU
        assert s["launches"] == {k: 0 for k in KERNELS}
    assert 0 < ctl.steady_t <= ctl.t and ctl.steady_wall_time_s > 0


def test_sc_control_reaches_nodes(monkeypatch):
    """An SC that retunes node 0 mid-run over CRTS_MSG_CONTROL and enables
    feedback; the controller must receive TX_FREQ feedback.  The SC is
    registered for this test only."""
    from cognitive_radio_network_tpu_torch.runtime import engine
    from cognitive_radio_network_tpu_torch.runtime.scenario import CrtsParam, ScenarioController

    feedback_log = []
    monkeypatch.setattr(engine, "_CONTROLLERS", dict(engine._CONTROLLERS))

    @engine.register_controller("SC_TorchNetctlTest")
    class SC_TorchNetctlTest(ScenarioController):
        def initialize_node_fb(self):
            self.set_node_parameter(0, CrtsParam.FB_EN, 1 << CrtsParam.TX_FREQ.value)
            self._retuned = False

        def execute(self):
            if self.fb is not None:
                feedback_log.append((self.fb.node, self.fb.param, self.fb.value))
            if not self._retuned:
                self._retuned = True
                self.set_node_parameter(0, CrtsParam.TX_FREQ, 837e6)

    cfg = _two_node_scenario(run_time=0.05)
    cfg.scenario_controller = "SC_TorchNetctlTest"
    cfg.sc_timeout_ms = 0.1
    _controller(cfg, 47734).run()
    tx_freq_fbs = [v for (n, p, v) in feedback_log if n == 0 and p is CrtsParam.TX_FREQ]
    assert 837e6 in tx_freq_fbs, f"feedback log: {feedback_log}"


def test_interferer_nodes_in_distributed_mode():
    """A CW interferer runs as its own OS process and the radio receives its
    energy through the controller-hosted medium; a duty-cycled one returns
    silent blocks, and the pipelined loop's speculative produce must not run
    twice on them: every node's tx cursor is exactly steps x block_len."""
    radio = NodeConfig(cognitive_engine="CE_Template", net_mean_throughput=200e3,
                       tx_freq=464e6, tx_rate=1e6, rx_freq=465e6, rx_rate=1e6)
    cw = NodeConfig(node_type="interferer", interference_type="cw", tx_freq=465e6,
                    tx_rate=1e6, tx_gain=25.0, duty_cycle=1.0)
    gated = NodeConfig(node_type="interferer", interference_type="cw", tx_freq=465e6,
                       duty_cycle=0.3, period=0.02)
    cfg = ScenarioConfig(num_nodes=3, run_time=0.1, nodes=[radio, cw, gated], medium_rate=4e6,
                         medium_center=465e6, medium_block_len=16384,
                         medium_noise_power=1e-9, name="netctl_interferer")
    cfg.net_step_timeout_s = 30.0
    assert cfg.net_pipeline  # the default, and the mode under test
    ctl = _controller(cfg, 47735)
    summary = ctl.run()
    assert summary.bytes_sent[1] == summary.bytes_sent[2] == 0
    assert summary.bytes_sent[0] > 0
    steps = math.ceil(cfg.run_time / (cfg.medium_block_len / cfg.medium_rate))
    for i in range(3):
        assert ctl.summaries[i]["tx_samples"] == steps * cfg.medium_block_len, i


def test_node_crash_surfaces_stderr(tmp_path):
    """A node process that dies is detected, and the controller's error
    carries its traceback (the reference only noticed the disconnect,
    src/crts_controller.cpp:43-54)."""
    bad = tmp_path / "bad_radio.py"
    bad.write_text(
        "def create_node(node_id, medium_rate, medium_center, config):\n"
        "    raise RuntimeError('deliberate-crash-for-test')\n"
    )
    a = NodeConfig(cognitive_radio_type="python", python_file=str(bad), tx_freq=464e6,
                   rx_freq=466e6)
    b = NodeConfig(cognitive_engine="CE_Template", tx_freq=466e6, rx_freq=464e6)
    cfg = ScenarioConfig(num_nodes=2, run_time=0.02, nodes=[a, b], medium_rate=4e6,
                         medium_block_len=16384, name="netctl_crash")
    cfg.net_step_timeout_s = 30.0
    ctl = _controller(cfg, 47736)
    with pytest.raises((ConnectionError, TimeoutError)) as ei:
        ctl.run()
    assert "deliberate-crash-for-test" in str(ei.value)
    assert all(p.poll() is not None for p in ctl.procs)  # exact PIDs reaped


_LINK_CFG = """
num_nodes = 2; run_time = 0.1; seed = 3;
medium_rate = 4e6; medium_center = 465e6; medium_block_len = 16384; medium_noise_power = 1e-7;
node1 : { cognitive_engine = "CE_Template"; net_mean_throughput = 200e3; tx_freq = 464e6;
          rx_freq = 466e6; tx_rate = 1e6; rx_rate = 1e6; tx_gain_soft = -6.0; };
node2 : { cognitive_engine = "CE_Template"; net_mean_throughput = 200e3; tx_freq = 466e6;
          rx_freq = 464e6; tx_rate = 1e6; rx_rate = 1e6; tx_gain_soft = -6.0; };
"""


def test_cli_distributed_scenario(tmp_path):
    """``scenario -d`` through the CLI: one node process per node, the
    in-process run's summary line, exit 0."""
    cfg = tmp_path / "link.cfg"
    cfg.write_text(_LINK_CFG)
    cli = [sys.executable, "-m", "cognitive_radio_network_tpu_torch", "scenario", str(cfg),
           "--device", "cpu"]
    dist = subprocess.run(cli + ["-d", "-p", "47737"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert dist.returncode == 0, dist.stderr[-3000:]
    inproc = subprocess.run(cli + ["-l", str(tmp_path)], cwd=ROOT, capture_output=True,
                            text=True, timeout=300)
    assert inproc.returncode == 0, inproc.stderr[-3000:]
    line = dist.stdout.strip().splitlines()[-1]
    assert line == inproc.stdout.strip().splitlines()[-1]
    assert "valid_frames=[0, 0]" not in line


# ---------------------------------------------------------- device and argv


@pytest.mark.skipif("torch.cuda.is_available()", reason="checks the default device with no card")
def test_no_card_fails_once_before_anything_starts():
    """The default device is the card: the controller raises before it
    listens or launches, the node client before it dials, and the ``node``
    CLI exits non-zero at once."""
    with pytest.raises(RuntimeError, match="not available"):
        NetController(_two_node_scenario(), port=47738)
    srv = PyMsgTransport.listen(47738)  # nothing kept the port
    PyMsgTransport.close_server(srv)
    with pytest.raises(RuntimeError, match="not available"):
        run_node_client("127.0.0.1", 47739)  # nobody listens: no ConnectionError first
    proc = subprocess.run(
        [sys.executable, "-m", "cognitive_radio_network_tpu_torch", "node", "-a", "127.0.0.1",
         "-p", "47739"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and "not available" in proc.stderr


# ------------------------------------------------------- larger fleets (slow)


def _eight_node_scenario(run_time=0.06):
    """tests/test_netctl.py::_eight_node_scenario: 3 FDD pairs + 2
    interferers, 16 MHz medium."""
    common = dict(cognitive_engine="CE_Template", ce_timeout_ms=1000.0,
                  net_mean_throughput=200e3, tx_rate=1e6, rx_rate=1e6, tx_gain=20.0,
                  rx_gain=20.0, tx_gain_soft=-6.0)
    nodes = []
    for base in (461e6, 465e6, 469e6):
        nodes.append(NodeConfig(tx_freq=base, rx_freq=base + 2e6, **common))
        nodes.append(NodeConfig(tx_freq=base + 2e6, rx_freq=base, **common))
    nodes.append(NodeConfig(node_type="interferer", interference_type="cw", tx_freq=473e6,
                            tx_gain=15.0, duty_cycle=0.5, period=0.01))
    nodes.append(NodeConfig(node_type="interferer", interference_type="noise", tx_freq=459e6,
                            tx_gain=10.0, tx_freq_behavior="sweep", tx_freq_min=458e6,
                            tx_freq_max=460e6, tx_freq_dwell_time=0.005,
                            tx_freq_resolution=0.5e6))
    return ScenarioConfig(num_nodes=8, run_time=run_time, nodes=nodes, medium_rate=16e6,
                          medium_center=466e6, medium_block_len=65536, medium_noise_power=1e-8,
                          name="eight_node_dist")


@pytest.mark.slow
class TestManyProcessScenario:
    def test_eight_node_distributed_matches_inprocess(self):
        inproc = ScenarioRuntime(_eight_node_scenario(), device="cpu").run()
        dist = _controller(_eight_node_scenario(), 47741, "auto").run()
        assert dataclasses.asdict(dist) == dataclasses.asdict(inproc)
        assert all(dist.bytes_sent[i] > 0 for i in range(6))
        assert sum(dist.valid_frames) > 0

    def test_forty_eight_process_smoke(self):
        """The reference's 48-node cap as real OS processes
        (include/crts.hpp:189): 8 cells x (2 FDD pairs + 2 interferers)."""
        from cognitive_radio_network_tpu_torch.runtime.config import (
            build_forty_eight_node_scenario,
        )

        cfg, gains = build_forty_eight_node_scenario(run_time=0.02)
        ctl = _controller(cfg, 47742, "auto")
        ctl.medium.gains = gains
        summary = ctl.run()
        assert not ctl.terminated, "hit the wall-clock guard"
        assert len(ctl.summaries) == 48, sorted(ctl.summaries)
        for i in (i for i in range(48) if i % 6 < 4):
            assert summary.bytes_sent[i] > 0, f"node {i} sent nothing"


@pytest.mark.slow
class TestSshLaunch:
    """launch='ssh' with the ssh argv prefix stubbed by a shell that drops
    the host argument and runs the remote command locally: argv build, PID
    handshake, sysout capture and exact-PID remote kill, end to end."""

    @staticmethod
    def _stub_ssh(tmp_path):
        stub = tmp_path / "fake_ssh"
        stub.write_text('#!/bin/sh\n# $1 = user@host, $2 = remote command\nexec sh -c "$2"\n')
        stub.chmod(0o755)
        return stub

    def test_ssh_launch_end_to_end(self, tmp_path):
        cfg = _two_node_scenario()
        for nc in cfg.nodes:
            nc.server_ip, nc.server_user = "127.0.0.1", "tester"
        ctl = _controller(cfg, 47743, launch="ssh", ssh_cmd=[str(self._stub_ssh(tmp_path))],
                          remote_python=sys.executable, sysout_dir=str(tmp_path / "sysout"))
        summary = ctl.run()
        assert sum(summary.valid_frames) > 0
        for i in range(2):
            assert (tmp_path / "sysout" / f"{cfg.name}_node{i}.log").exists()
            assert ctl._remote_pid(i) is not None
        assert ctl._ssh_hosts == ["tester@127.0.0.1"] * 2

    def test_ssh_launch_env_isolated(self, tmp_path):
        """The remote command stands alone: a stub that wipes the environment
        and the cwd like a fresh ssh login."""
        remote_home = tmp_path / "remote_home"
        remote_home.mkdir()
        stub = tmp_path / "fake_ssh_isolated"
        stub.write_text(
            "#!/bin/sh\n"
            f"cd {remote_home} || exit 1\n"
            'echo "CRN_REMOTE_CWD $(pwd)"\n'
            f"exec env -i HOME={remote_home} PATH=/usr/bin:/bin PYTHONPATH={ROOT} "
            'sh -c "$2"\n'
        )
        stub.chmod(0o755)
        cfg = _two_node_scenario()
        for nc in cfg.nodes:
            nc.server_ip, nc.server_user = "127.0.0.1", "remoteuser"
        ctl = _controller(cfg, 47744, launch="ssh", ssh_cmd=[str(stub)],
                          remote_python=sys.executable, sysout_dir=str(tmp_path / "sysout"))
        summary = ctl.run()
        assert sum(summary.valid_frames) > 0
        for i in range(2):
            text = (tmp_path / "sysout" / f"{cfg.name}_node{i}.log").read_text()
            assert f"CRN_REMOTE_CWD {remote_home}" in text, text[:400]
            assert ctl._remote_pid(i) is not None

    def test_ssh_forceful_kill_exact_pid(self, tmp_path):
        """A node that never connects is remote-killed by its exact PID on
        cleanup rather than leaking."""
        import os
        import time

        ctl = _controller(
            _two_node_scenario(run_time=0.02), 47745, launch="ssh", accept_timeout_s=6.0,
            ssh_cmd=[str(self._stub_ssh(tmp_path))],
            remote_python=f"{sys.executable} -c 'import time; time.sleep(600)' #",
            sysout_dir=str(tmp_path / "sysout"),
        )
        with pytest.raises(TimeoutError):
            ctl.run()
        for i in range(2):
            pid = ctl._remote_pid(i)
            assert pid is not None
            deadline = time.time() + 10
            while time.time() < deadline:
                try:
                    os.kill(pid, 0)
                except ProcessLookupError:
                    break
                time.sleep(0.2)
            else:
                pytest.fail(f"remote pid {pid} leaked")
