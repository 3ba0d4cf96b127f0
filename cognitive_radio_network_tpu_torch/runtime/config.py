"""Typed scenario configuration + libconfig-style parser.

Replaces the three-level libconfig hierarchy of src/crts.cpp (master file ->
scenario file -> per-node ``nodeN`` blocks, :98-689) with dataclasses, while
keeping a reader for the reference's ``.cfg`` syntax so existing scenario
files carry over (``key = value;`` scalars and ``name : { ... };`` groups).

Port of ``cognitive_radio_network_tpu/runtime/config.py``, copied: the same
files parse to the same values, so a config names the same scenario in both
packages.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Any, Optional

__all__ = [
    "MasterConfig",
    "ScenarioConfig",
    "NodeConfig",
    "parse_cfg",
    "scenario_from_dict",
    "load_scenario",
    "load_master",
    "build_forty_eight_node_scenario",
]


@dataclasses.dataclass
class NodeConfig:
    """Per-node block (struct node_parameters, include/crts.hpp:102-181)."""

    node_type: str = "cognitive radio"  # "cognitive radio" | "interferer"
    cognitive_radio_type: str = "ecr"  # "ecr" | "python" (external radios)
    python_file: str = ""
    python_args: str = ""
    team_name: str = ""
    server_ip: str = "127.0.0.1"
    # ssh login for launch="ssh" ("" = current user), crts_controller.cpp:404
    server_user: str = ""
    crts_ip: str = "10.0.0.2"
    target_ip: str = "10.0.0.3"

    net_traffic_type: str = "stream"  # stream | burst | poisson | udp
    net_burst_length: int = 1
    net_mean_throughput: float = 1e6
    # net_traffic_type="udp": real-application data plane (the reference's
    # TUN+UDP capability class, runtime/traffic.py::UdpBridge) — ingress
    # datagrams on udp_listen_port ride the link; decoded payloads are
    # forwarded to (udp_forward_addr, udp_forward_port)
    udp_listen_port: int = 0  # 0 = ephemeral (read node.udp_bridge.listen_port)
    udp_forward_addr: str = "127.0.0.1"
    udp_forward_port: int = 0  # 0 = do not forward

    cognitive_engine: str = "CE_Template"
    ce_timeout_ms: float = 1000.0
    ce_args: str = ""

    print_rx_frame_metrics: bool = False
    # fault injection (no reference .cfg equivalent; gives the reference's
    # UHD overflow/underrun CE events a producer in simulation,
    # src/extensible_cognitive_radio.cpp:1326-1347):
    # drop every Nth rx block (0 = never) -> UHD_OVERFLOW event
    rx_overflow_interval: int = 0
    # rx frame-scan batching (CPU/latency tradeoff, no reference .cfg
    # equivalent): scan every N accumulated hot blocks instead of each
    # block.  N=1 is the exact per-block behavior; N=2 halves per-node
    # scan CPU at <= one block (~4 ms) extra receive latency — far below
    # every CE timescale (100 ms+).  Cold blocks flush the accumulator.
    rx_scan_blocks: int = 1
    # detect continuous-tx starvation mid-burst -> UHD_UNDERRUN event
    tx_underrun_detect: bool = False
    log_phy_rx: bool = False
    log_phy_tx: bool = False
    log_net_rx: bool = False
    log_net_tx: bool = False
    generate_octave_logs: bool = False
    phy_rx_log_file: str = ""
    phy_tx_log_file: str = ""
    net_rx_log_file: str = ""
    net_tx_log_file: str = ""

    rx_freq: float = 460e6
    rx_rate: float = 500e3
    rx_gain: float = 20.0
    tx_freq: float = 460e6
    tx_rate: float = 1e6
    tx_gain: float = 20.0
    tx_gain_soft: float = -12.0

    rx_subcarriers: int = 32
    rx_cp_len: int = 16
    rx_taper_len: int = 4
    rx_subcarrier_alloc_method: str = "default"
    rx_guard_subcarriers: int = 2
    rx_central_nulls: int = 2
    rx_pilot_freq: int = 4
    tx_subcarriers: int = 32
    tx_cp_len: int = 16
    tx_taper_len: int = 4
    tx_modulation: str = "qam4"
    tx_crc: str = "crc32"
    tx_fec0: str = "h128"
    tx_fec1: str = "none"
    tx_subcarrier_alloc_method: str = "default"
    tx_guard_subcarriers: int = 2
    tx_central_nulls: int = 2
    tx_pilot_freq: int = 4
    # custom-mode run-length allocation [(type, count), ...], types
    # "null"/"pilot"/"data" (the sc_type_N/sc_num_N groups of
    # src/crts.cpp:429-481)
    tx_subcarrier_alloc: list = dataclasses.field(default_factory=list)
    rx_subcarrier_alloc: list = dataclasses.field(default_factory=list)

    # interferer-only block (include/crts.hpp:167-180)
    interference_type: str = "cw"
    period: float = 1.0
    duty_cycle: float = 1.0
    tx_freq_behavior: str = "fixed"
    tx_freq_min: float = 0.0
    tx_freq_max: float = 0.0
    tx_freq_dwell_time: float = 1.0
    tx_freq_resolution: float = 1e6


@dataclasses.dataclass
class ScenarioConfig:
    """Scenario file (struct scenario_parameters, include/crts.hpp:31-56)."""

    num_nodes: int = 1
    run_time: float = 10.0
    scenario_controller: str = "SC_Template"
    sc_timeout_ms: float = 1000.0
    sc_args: str = ""
    nodes: list[NodeConfig] = dataclasses.field(default_factory=list)
    # simulation extensions (no reference equivalent: these replace hardware)
    medium_rate: float = 13e6
    medium_center: float = 833e6
    medium_block_len: int = 5120
    medium_noise_power: float = 1e-6
    seed: int = 0
    name: str = "scenario"
    # failure policy: "terminate" ends the scenario when a node errors (the
    # reference controller's behavior on node disconnect,
    # src/crts_controller.cpp:43-54); "continue" halts just the failed node
    on_node_failure: str = "terminate"
    # wall-clock guard (reference: run_time + 10 s forceful termination,
    # src/crts_controller.cpp:524-527); None disables
    max_wall_time_s: float | None = None
    # multi-process lockstep patience of the reference's distributed runtime
    # (runtime/netctl.py, not ported yet): how long controller/node wait for
    # the peer's next TX/RX_BLOCK
    net_step_timeout_s: float = 120.0
    # multi-process tx pipelining: node processes speculatively assemble
    # block N+1 while the controller still works on block N.  A CE/control
    # tx-param change then lands one block (~block_dt) later than in the
    # serial loop — the latency a physical radio has anyway between a CE
    # retune and the first frame actually transmitted with it (liquid's
    # framegen is recreated BETWEEN frames; in-flight samples keep the old
    # params, src/extensible_cognitive_radio.cpp:829-881).  Set false for
    # bit-identical serial lockstep semantics.
    net_pipeline: bool = True
    # where the reference's per-block link PHY runs ("host": its JAX CPU
    # backend; "device": where JAX places it).  Parsed and kept so configs
    # stay equal across the packages; in the port the nodes' device work
    # runs on ScenarioRuntime's ``device`` whatever this says.
    phy_placement: str = "host"


@dataclasses.dataclass
class MasterConfig:
    """Master file (read_master_parameters, src/crts.cpp:98-173)."""

    scenarios: list[tuple[str, int]] = dataclasses.field(default_factory=list)
    octave_log_summary: bool = False


# ----------------------------------------------------------------------
# libconfig-style parser (subset: scalars, strings, groups)
# ----------------------------------------------------------------------

_TOKEN = re.compile(
    r"""
    \s*(?:
      (?P<comment>//[^\n]*|\#[^\n]*|/\*.*?\*/)
    | (?P<lbrace>\{) | (?P<rbrace>\}) | (?P<semi>;) | (?P<assign>[:=])
    | (?P<string>"(?:[^"\\]|\\.)*")
    | (?P<number>[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?)
    | (?P<bool>true|false)
    | (?P<name>[A-Za-z_][A-Za-z0-9_.-]*)
    )""",
    re.VERBOSE | re.DOTALL,
)


def parse_cfg(text: str) -> dict[str, Any]:
    """Parse libconfig-subset text into nested dicts."""
    tokens = []
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m:
            if text[pos:].strip() == "":
                break  # trailing whitespace
            raise ValueError(f"cfg parse error at: {text[pos:pos+40]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "comment" or kind is None:
            continue
        tokens.append((kind, m.group(kind)))

    def parse_group(i: int) -> tuple[dict, int]:
        out: dict[str, Any] = {}
        while i < len(tokens):
            kind, val = tokens[i]
            if kind == "rbrace":
                return out, i + 1
            if kind != "name":
                i += 1
                continue
            key = val
            i += 1
            if i < len(tokens) and tokens[i][0] == "assign":
                i += 1
            if i >= len(tokens):
                break
            kind2, val2 = tokens[i]
            if kind2 == "lbrace":
                sub, i = parse_group(i + 1)
                out[key] = sub
            elif kind2 == "string":
                out[key] = val2[1:-1]
                i += 1
            elif kind2 == "number":
                f = float(val2)
                out[key] = int(f) if f.is_integer() and "." not in val2 and "e" not in val2.lower() else f
                i += 1
            elif kind2 == "bool":
                out[key] = val2 == "true"
                i += 1
            else:
                i += 1
            if i < len(tokens) and tokens[i][0] == "semi":
                i += 1
        return out, i

    out, _ = parse_group(0)
    return out


_NODE_KEY_ALIASES = {
    "generate_octave_log_file": "generate_octave_logs",
    "CE": "cognitive_engine",
}


def _parse_alloc_group(g: dict[str, Any]) -> list:
    """sc_type_N / sc_num_N group -> [(type, count), ...] in N order
    (sc_num omitted means 1, src/crts.cpp:440-446)."""
    runs = []
    i = 1
    while f"sc_type_{i}" in g:
        runs.append((str(g[f"sc_type_{i}"]), int(g.get(f"sc_num_{i}", 1))))
        i += 1
    return runs


def _node_from_dict(d: dict[str, Any]) -> NodeConfig:
    node = NodeConfig()
    for k, v in d.items():
        k = _NODE_KEY_ALIASES.get(k, k)
        if k in ("tx_subcarrier_alloc", "rx_subcarrier_alloc"):
            if isinstance(v, dict):
                v = _parse_alloc_group(v)
            setattr(node, k, [tuple(r) for r in v])
            continue
        if hasattr(node, k):
            cur = getattr(node, k)
            if isinstance(cur, bool):
                v = bool(v)
            elif isinstance(cur, float) and not isinstance(v, str):
                v = float(v)
            setattr(node, k, v)
    return node


def scenario_from_dict(d: dict[str, Any], name: str = "scenario") -> ScenarioConfig:
    sc = ScenarioConfig(name=name)
    for k in (
        "num_nodes",
        "run_time",
        "sc_timeout_ms",
        "sc_args",
        "medium_rate",
        "medium_center",
        "medium_block_len",
        "medium_noise_power",
        "seed",
        "phy_placement",
        "max_wall_time_s",
        "net_pipeline",
    ):
        if k in d:
            setattr(sc, k, d[k])
    if "scenario_controller" in d:
        sc.scenario_controller = d["scenario_controller"]
    elif "SC" in d:
        sc.scenario_controller = d["SC"]
    n = int(d.get("num_nodes", 0))
    for i in range(1, max(n, 1) + 1):
        key = f"node{i}"
        if key in d:
            sc.nodes.append(_node_from_dict(d[key]))
    sc.num_nodes = len(sc.nodes) or int(d.get("num_nodes", 1))
    return sc


def load_scenario(path: str | Path) -> ScenarioConfig:
    p = Path(path)
    return scenario_from_dict(parse_cfg(p.read_text()), name=p.stem)


def load_master(path: str | Path) -> MasterConfig:
    """Master format (scenario_master_template.cfg): num_scenarios,
    reps_all_scenarios, scenario_N blocks with name + reps."""
    d = parse_cfg(Path(path).read_text())
    m = MasterConfig(octave_log_summary=bool(d.get("octave_log_summary", False)))
    n = int(d.get("num_scenarios", 0))
    default_reps = int(d.get("reps_all_scenarios", 1))
    for i in range(1, n + 1):
        blk = d.get(f"scenario_{i}", {})
        if isinstance(blk, dict) and "name" in blk:
            m.scenarios.append((blk["name"], int(blk.get("reps", default_reps))))
    return m


def build_forty_eight_node_scenario(
    run_time: float = 1.0,
) -> tuple[ScenarioConfig, "object"]:
    """The reference's 48-node cap (include/crts.hpp:189) as a runnable
    scenario: 8 frequency-reuse cells x (2 FDD radio pairs + 2
    interferers) sharing one 16 MHz medium, cross-cell gain 0 (the celled
    gain matrix rides the Medium's cell fast path, runtime/medium.py).

    Returns (cfg, gains); callers apply ``ctl.medium.gains = gains``.
    The reference's bench.py and its netctl process test run it.
    """
    import numpy as np

    common = dict(
        cognitive_engine="CE_Template",
        ce_timeout_ms=1000.0,
        net_mean_throughput=400e3,
        tx_rate=2e6,
        rx_rate=2e6,
        tx_gain=20.0,
        rx_gain=20.0,
        tx_gain_soft=-6.0,
        rx_scan_blocks=4,  # scan batching: per-node CPU, +<=3 blocks (~12 ms) latency
    )
    nodes = []
    cells, per_cell = 8, 6
    for _cell in range(cells):
        for base in (461e6, 465e6):
            nodes.append(NodeConfig(tx_freq=base, rx_freq=base + 2e6, **common))
            nodes.append(NodeConfig(tx_freq=base + 2e6, rx_freq=base, **common))
        nodes.append(
            NodeConfig(
                node_type="interferer",
                interference_type="cw",
                tx_freq=470e6,
                tx_gain=10.0,
                duty_cycle=0.5,
                period=0.01,
            )
        )
        nodes.append(
            NodeConfig(
                node_type="interferer",
                interference_type="noise",
                tx_freq=459e6,
                tx_gain=5.0,
            )
        )
    assert len(nodes) == cells * per_cell == 48
    cfg = ScenarioConfig(
        num_nodes=48,
        run_time=run_time,
        nodes=nodes,
        medium_rate=16e6,
        medium_center=466e6,
        medium_block_len=65536,
        medium_noise_power=1e-8,
        max_wall_time_s=560.0,
        # early steps trace/compile under 48-process contention; the
        # default 120 s trips when other work shares the host
        net_step_timeout_s=300.0,
        name="forty_eight_process",
    )
    gains = np.zeros((48, 48), np.float32)
    for c in range(cells):
        s = c * per_cell
        gains[s : s + per_cell, s : s + per_cell] = 1.0
    np.fill_diagonal(gains, 0.0)
    return cfg, gains
