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
        "cognitive_radio_network_tpu_torch.phy.stream\n"
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
