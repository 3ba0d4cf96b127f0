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
        "cognitive_radio_network_tpu_torch.parallel.mesh, "
        "cognitive_radio_network_tpu_torch.parallel.collectives, "
        "cognitive_radio_network_tpu_torch.parallel.halo, "
        "cognitive_radio_network_tpu_torch.parallel.multihost, "
        "cognitive_radio_network_tpu_torch.parallel.launch, "
        "cognitive_radio_network_tpu_torch.parallel.phylink, "
        "cognitive_radio_network_tpu_torch.graft_entry, "
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
        "cognitive_radio_network_tpu_torch.controllers.template, "
        "cognitive_radio_network_tpu_torch.models.train, "
        "cognitive_radio_network_tpu_torch.tools, "
        "cognitive_radio_network_tpu_torch.tools.spectrum_analyzer, "
        "cognitive_radio_network_tpu_torch.phy.gmsk, "
        "cognitive_radio_network_tpu_torch.utils.timer, "
        "cognitive_radio_network_tpu_torch.utils.profiling\n"
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


def test_public_names_of_the_reference_are_exported():
    """The reference's re-exports and kernel wrappers named in its ``__all__``
    have counterparts of the same name in the port's packages."""
    import importlib

    import cognitive_radio_network_tpu_torch.env as env
    import cognitive_radio_network_tpu_torch.signal as signal
    from cognitive_radio_network_tpu_torch.env.interference import (
        InterfererConfig,
        synthesize_interference,
    )
    from cognitive_radio_network_tpu_torch.signal.msequence import MSequence, msequence_bytes

    # the package binds the function's name over its module's: import by path
    fused_sense_ct = importlib.import_module("cognitive_radio_network_tpu_torch.ops.fused_sense_ct")
    for module, names in ((signal, ("MSequence", "msequence_bytes")),
                          (env, ("InterfererConfig", "synthesize_interference")),
                          (fused_sense_ct, ("ct_band_features",))):
        for name in names:
            assert name in module.__all__ and hasattr(module, name), (module.__name__, name)
    assert signal.MSequence is MSequence and signal.msequence_bytes is msequence_bytes
    assert env.InterfererConfig is InterfererConfig
    assert env.synthesize_interference is synthesize_interference


def _modules_loaded_in_a_rank() -> list:
    """Run in a rank: load the multi-device layer, then list what of JAX and
    of the JAX package the process holds."""
    import cognitive_radio_network_tpu_torch.graft_entry  # noqa: F401
    import cognitive_radio_network_tpu_torch.parallel.phylink  # noqa: F401

    return sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cognitive_radio_network_tpu")
    )


def test_a_rank_started_by_run_ranks_loads_without_jax():
    """The test process holds JAX; a rank it starts (spawned, not forked)
    does not."""
    from cognitive_radio_network_tpu_torch.parallel.launch import run_ranks

    got = run_ranks(_modules_loaded_in_a_rank, 2, backend="gloo", device="cpu", timeout_s=120)
    assert got == [[], []]


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
