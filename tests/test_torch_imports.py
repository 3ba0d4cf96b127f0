"""Guard: the PyTorch port imports neither JAX nor the JAX package."""

import re
import subprocess
import sys
from pathlib import Path

PORT = Path(__file__).resolve().parents[1] / "cognitive_radio_network_tpu_torch"
_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|cognitive_radio_network_tpu)(\.|\s|$)", re.MULTILINE
)


def test_no_port_source_imports_jax():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 10
    offenders = [
        f"{f.relative_to(PORT)}: {m.group(0).strip()}"
        for f in files
        for m in _FORBIDDEN.finditer(f.read_text())
    ]
    assert not offenders, offenders


def test_port_modules_load_without_jax():
    code = (
        "import sys\n"
        "import cognitive_radio_network_tpu_torch.__main__, "
        "cognitive_radio_network_tpu_torch.models, cognitive_radio_network_tpu_torch.env, "
        "cognitive_radio_network_tpu_torch.io, cognitive_radio_network_tpu_torch.ops, "
        "cognitive_radio_network_tpu_torch.signal, cognitive_radio_network_tpu_torch.utils, "
        "cognitive_radio_network_tpu_torch.phy, cognitive_radio_network_tpu_torch.ops.extract, "
        "cognitive_radio_network_tpu_torch.phy.framesync, "
        "cognitive_radio_network_tpu_torch.signal.msequence, "
        "cognitive_radio_network_tpu_torch.profile_link, "
        "cognitive_radio_network_tpu_torch.parallel, "
        "cognitive_radio_network_tpu_torch.parallel.wideband, "
        "cognitive_radio_network_tpu_torch.models.distributed, "
        "cognitive_radio_network_tpu_torch.signal.channelizer, "
        "cognitive_radio_network_tpu_torch.ops.fused_wideband, "
        "cognitive_radio_network_tpu_torch.ops.fused_sense, "
        "cognitive_radio_network_tpu_torch.ops.resolve, "
        "cognitive_radio_network_tpu_torch.ops._sense, "
        "cognitive_radio_network_tpu_torch.profile_resolve, "
        "cognitive_radio_network_tpu_torch.phy.stream, "
        "cognitive_radio_network_tpu_torch.signal.resample, "
        "cognitive_radio_network_tpu_torch.env.interference, "
        "cognitive_radio_network_tpu_torch.runtime, "
        "cognitive_radio_network_tpu_torch.runtime.engine, "
        "cognitive_radio_network_tpu_torch.runtime.scenario, "
        "cognitive_radio_network_tpu_torch.runtime.config, "
        "cognitive_radio_network_tpu_torch.runtime.stats, "
        "cognitive_radio_network_tpu_torch.runtime.traffic, "
        "cognitive_radio_network_tpu_torch.runtime.logging, "
        "cognitive_radio_network_tpu_torch.runtime.medium, "
        "cognitive_radio_network_tpu_torch.runtime.radio, "
        "cognitive_radio_network_tpu_torch.runtime.node, "
        "cognitive_radio_network_tpu_torch.runtime.control, "
        "cognitive_radio_network_tpu_torch.runtime.controller, "
        "cognitive_radio_network_tpu_torch.runtime.netctl, "
        "cognitive_radio_network_tpu_torch.runtime.procradio, "
        "cognitive_radio_network_tpu_torch.native, "
        "cognitive_radio_network_tpu_torch.utils.build, "
        "cognitive_radio_network_tpu_torch.engines, "
        "cognitive_radio_network_tpu_torch.engines.template, "
        "cognitive_radio_network_tpu_torch.engines.random_pu, "
        "cognitive_radio_network_tpu_torch.engines.tx_channel_x, "
        "cognitive_radio_network_tpu_torch.engines.markov_pu, "
        "cognitive_radio_network_tpu_torch.engines.predictive_node, "
        "cognitive_radio_network_tpu_torch.controllers, "
        "cognitive_radio_network_tpu_torch.controllers.template\n"
        "from cognitive_radio_network_tpu_torch.runtime import engine_names, controller_names\n"
        "assert len(engine_names()) == 5 and controller_names() == ['SC_Template']\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'cognitive_radio_network_tpu')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=PORT.parent,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_every_spawned_argv_names_the_port():
    """The node argv, the ssh remote command and the radio-host argv start
    the port's package with the controller's device, never the JAX one."""
    import dataclasses

    import torch

    from cognitive_radio_network_tpu_torch.runtime import NodeConfig, ScenarioConfig
    from cognitive_radio_network_tpu_torch.runtime.netctl import NetController
    from cognitive_radio_network_tpu_torch.runtime.procradio import ProcessRadioNode

    cfg = ScenarioConfig(num_nodes=2, nodes=[NodeConfig(), NodeConfig()])
    ctl = NetController(cfg, port=4444, launch="ssh", controller_addr="10.0.0.1",
                        remote_python="python3", device="cpu")
    argv = ctl._node_argv("127.0.0.1")
    assert argv[0] == sys.executable
    assert argv[1:4] == ["-m", "cognitive_radio_network_tpu_torch", "node"]
    assert argv[argv.index("--device") + 1] == "cpu"
    remote = ctl._remote_command()
    assert remote.startswith("echo CRN_NODE_PID $$; exec python3 -m "
                             "cognitive_radio_network_tpu_torch node -a 10.0.0.1 -p 4444")
    assert remote.endswith("--device cpu")
    nc = dataclasses.replace(NodeConfig(), python_file="r.py")
    radio = ProcessRadioNode.argv(0, 1e6, 460e6, nc, torch.device("cpu"))
    assert radio[1:4] == ["-m", "cognitive_radio_network_tpu_torch", "radio-host"]
    assert radio[radio.index("--device") + 1] == "cpu"
    for words in (argv, remote.split(), radio):
        assert "cognitive_radio_network_tpu" not in words
        assert not any(re.search(r"cognitive_radio_network_tpu(?!_torch)", w) for w in words)
