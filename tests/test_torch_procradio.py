"""Process-isolated radios of the port (runtime/procradio.py), after
tests/test_failure_and_plugins.py::TestProcessRadio.

``cognitive_radio_type="python-process"``: the third-party radio runs as its
own OS process (``python -m cognitive_radio_network_tpu_torch radio-host``,
the reference's fork + execvp isolation model,
src/crts_cognitive_radio.cpp:660-720), stepped over a pipe protocol.  The
user radio files here build port nodes; the child runs on the parent's device
(``--device``), which reaches ``create_node`` as ``device=`` when it takes
that keyword.  Everything runs with ``device="cpu"``."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cognitive_radio_network_tpu_torch.runtime import NodeConfig, ScenarioConfig, ScenarioRuntime
from cognitive_radio_network_tpu_torch.runtime.control import build_node
from cognitive_radio_network_tpu_torch.runtime.medium import MediumConfig
from cognitive_radio_network_tpu_torch.runtime.procradio import ProcessRadioNode

ROOT = Path(__file__).resolve().parents[1]


def _tiny_scenario(**kw):
    common = dict(tx_freq=460e6, rx_freq=460e6, tx_rate=1e6, rx_rate=1e6, ce_timeout_ms=50.0)
    return ScenarioConfig(
        num_nodes=2, run_time=0.1, nodes=[NodeConfig(**common), NodeConfig(**common)],
        medium_rate=1e6, medium_center=460e6, medium_block_len=4096, name="tiny", **kw,
    )


PROC_RADIO = '''
from cognitive_radio_network_tpu_torch.runtime.config import NodeConfig
from cognitive_radio_network_tpu_torch.runtime.control import build_node
from cognitive_radio_network_tpu_torch.runtime.medium import MediumConfig

def create_node(node_id, medium_rate, medium_center, config, device):
    # a third-party radio built FROM the port itself: a full ECR-style radio
    # node with traffic, on the device its runtime hands down
    print("user radio stdout noise", node_id)  # must not corrupt the protocol
    mcfg = MediumConfig(sample_rate_hz=medium_rate, center_hz=medium_center)
    nc = NodeConfig(**vars(config))
    nc.cognitive_radio_type = "ecr"
    node = build_node(node_id, nc, mcfg, None, device=device)
    assert node.radio.device == device
    return node
'''

CRASHY_RADIO = '''
class CrashyNode:
    def __init__(self, node_id):
        self.node_id = node_id
        self.blocks = 0
        self.started = False
    def start(self): self.started = True
    def poll_traffic(self, t): pass
    def pull_tx_block(self, n): return None
    def push_rx_block(self, block, t):
        self.blocks += 1
        if self.blocks >= 5:
            raise RuntimeError("user radio bug")
    def push_rx_silence(self, n, t): self.push_rx_block(None, t)
    def run_ce(self, t): pass
    def drain_rx_packets(self, t): pass

def create_node(node_id, medium_rate, medium_center, config):
    return CrashyNode(node_id)
'''

DEVICE_PROBE = '''
class Probe:
    def __init__(self, device):
        self.device, self.started, self.rx_packets = device, False, []
    def start(self): self.started = True
    def poll_traffic(self, t): pass
    def pull_tx_block(self, n): return None
    def push_rx_block(self, block, t): pass
    def run_ce(self, t): pass
    def drain_rx_packets(self, t): pass

def create_node(node_id, medium_rate, medium_center, config, **kw):
    return Probe(kw.get("device"))
'''


def _with_radio(tmp_path, source, radio_type="python-process", **kw):
    f = tmp_path / "user_radio.py"
    f.write_text(source)
    cfg = _tiny_scenario(**kw)
    cfg.run_time = 0.3
    cfg.nodes[1].cognitive_radio_type = radio_type
    cfg.nodes[1].python_file = str(f)
    return cfg


def test_process_radio_carries_a_live_link(tmp_path):
    """The external radio process transmits real frames that the in-process
    ECR partner decodes — the full data plane through the child, with user
    stdout noise that must not corrupt the pipe."""
    rt = ScenarioRuntime(_with_radio(tmp_path, PROC_RADIO), device="cpu")
    rt.run()
    assert not rt.failed_nodes, rt.failed_nodes
    assert type(rt.nodes[1]).__name__ == "ProcessRadioNode"
    assert len(rt.nodes[0].radio.stats.records) > 0  # node 0 heard the child's frames
    assert all(r.valid for r in rt.nodes[0].radio.stats.records)
    assert rt.nodes[1]._proc.poll() is not None  # child reaped


def test_crashing_process_radio_is_isolated(tmp_path):
    """A buggy user radio kills its process, not the scenario: the node is
    marked failed, everything else runs to the end."""
    cfg = _with_radio(tmp_path, CRASHY_RADIO, on_node_failure="continue")
    rt = ScenarioRuntime(cfg, device="cpu")
    rt.run()
    assert 1 in rt.failed_nodes and "radio-host" in rt.failed_nodes[1]
    assert 0 not in rt.failed_nodes
    assert rt.t >= cfg.run_time
    assert rt.nodes[1]._proc.poll() is not None


@pytest.mark.parametrize("radio_type", ["python", "python-process"])
def test_user_radio_gets_the_runtimes_device(tmp_path, radio_type):
    """One rule for both plug-in types: ``device=`` reaches a ``create_node``
    that takes it (here through ``**kw``)."""
    cfg = _with_radio(tmp_path, DEVICE_PROBE, radio_type)
    nc = cfg.nodes[1]
    node = build_node(1, nc, MediumConfig(), None, device=torch.device("cpu"))
    try:
        if radio_type == "python":
            assert node.device == torch.device("cpu")
        else:
            node.start()  # the child built its Probe, and answered
            argv = node._proc.args
            assert argv[argv.index("--device") + 1] == "cpu"
    finally:
        getattr(node, "close", lambda: None)()


@pytest.mark.skipif("torch.cuda.is_available()", reason="checks the default device with no card")
def test_no_card_raises_at_once(tmp_path):
    """With no card the default device raises in the parent before a child
    is spawned, and the radio-host child raises before it loads the file."""
    nc = NodeConfig(cognitive_radio_type="python-process", python_file=str(tmp_path / "x.py"))
    with pytest.raises(RuntimeError, match="not available"):
        ProcessRadioNode(0, 1e6, 460e6, nc)
    proc = subprocess.run(
        [sys.executable, "-m", "cognitive_radio_network_tpu_torch", "radio-host",
         str(tmp_path / "never_loaded.py"), "--node-id", "0", "--medium-rate", "1e6",
         "--medium-center", "460e6", "--config-json", "{}"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "not available" in proc.stderr and "never_loaded" not in proc.stderr
