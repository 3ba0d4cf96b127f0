"""Scenario orchestration — port of ``crts_controller``.

The reference controller SSH-launches node processes and speaks raw-struct
TCP (src/crts_controller.cpp:166-602).  Here a scenario is an in-process
simulation: the runtime builds nodes + medium from the typed config, steps
the world in medium blocks, applies SC control messages, performs the node
side's delta-based feedback detection (src/crts_cognitive_radio.cpp:208-383),
and writes the end-of-run summary (log_scenario_summary,
src/crts_controller.cpp:115-142).  ``run_master`` drives the
master -> scenario -> repetition loop (:300-599).

Port of ``cognitive_radio_network_tpu/runtime/controller.py``.  Where the
nodes' device work runs is the runtime's ``device`` (the card unless the
caller asks for the CPU); the config's ``phy_placement``, which in the
reference picks a JAX backend for the link PHY, moves nothing here.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

import torch

from cognitive_radio_network_tpu_torch.runtime.config import (
    MasterConfig,
    NodeConfig,
    ScenarioConfig,
)
from cognitive_radio_network_tpu_torch.runtime.control import (
    FB_GETTERS,
    apply_node_control,
    build_node,
)
from cognitive_radio_network_tpu_torch.runtime.engine import create_controller
from cognitive_radio_network_tpu_torch.runtime.logging import LogSink
from cognitive_radio_network_tpu_torch.runtime.medium import Medium, MediumConfig
from cognitive_radio_network_tpu_torch.runtime.node import InterfererNode, RadioNode
from cognitive_radio_network_tpu_torch.runtime.scenario import CrtsParam, Feedback
from cognitive_radio_network_tpu_torch.utils.device import require_device

__all__ = [
    "ScenarioRuntime",
    "ScenarioSummary",
    "run_master",
]


@dataclasses.dataclass
class ScenarioSummary:
    """Per-node results (the controller's octave summary matrix,
    src/crts_controller.cpp:115-142)."""

    scenario: str
    rep: int
    bytes_sent: list[int]
    bytes_received: list[int]
    frames_received: list[int]
    valid_frames: list[int]


class ScenarioRuntime:
    """One scenario in this process, its nodes' device work (tx chains,
    receivers, sensing) on ``device``: the card unless the caller asks for
    the CPU; with no card the default raises here, before any node is
    built."""

    def __init__(
        self,
        cfg: ScenarioConfig,
        log_sink: LogSink | None = None,
        *,
        device: torch.device | str = "cuda",
    ):
        self.device = require_device(device)
        self.cfg = cfg
        self.log = log_sink or LogSink()
        mcfg = MediumConfig(
            sample_rate_hz=cfg.medium_rate,
            center_hz=cfg.medium_center,
            block_len=cfg.medium_block_len,
            noise_power=cfg.medium_noise_power,
            seed=cfg.seed,
        )
        self.medium_cfg = mcfg
        self.nodes: list[Any] = [
            build_node(i, nc, mcfg, self.log, device=self.device)
            for i, nc in enumerate(cfg.nodes)
        ]
        self.medium = Medium(mcfg, len(self.nodes))
        self.sc = create_controller(
            cfg.scenario_controller, cfg.sc_args.split() if cfg.sc_args else []
        )
        self.sc.runtime = self
        self.sc.sc_timeout_ms = cfg.sc_timeout_ms
        self.t = 0.0
        self._last_fb: dict[tuple[int, CrtsParam], Any] = {}
        self._last_sc_t = 0.0
        self._last_stats_fb_t: dict[int, float] = {}
        self.failed_nodes: dict[int, str] = {}
        self.terminated = False
        self.wall_time_s = 0.0  # set by run(): realtime factor = run_time / this

    # -- control channel (set_node_parameter -> apply_control_msg,
    #    src/crts_cognitive_radio.cpp:127-206) --

    def apply_control(self, node_idx: int, param: CrtsParam, value) -> None:
        apply_node_control(
            self.nodes[node_idx],
            param,
            value,
            on_fb_en=lambda mask: self.sc.enable_feedback(node_idx, mask),
        )

    # -- feedback (delta detection, src/crts_cognitive_radio.cpp:208-383) --

    _FB_GETTERS = FB_GETTERS

    def _collect_feedback(self) -> None:
        for i, node in enumerate(self.nodes):
            if isinstance(node, InterfererNode):
                continue
            mask = self.sc.get_feedback_enables(i)
            if not mask:
                continue
            for param, getter in self._FB_GETTERS.items():
                if not (mask >> param.value) & 1:
                    continue
                val = getter(node.radio)
                key = (i, param)
                if self._last_fb.get(key) != val:
                    self._last_fb[key] = val
                    self.sc.receive_feedback(Feedback(i, param, val, self.t))
            # periodic rx statistics feedback
            if (mask >> CrtsParam.RX_STATS.value) & 1:
                period = node.radio.rx_stat_fb_period_s or 1.0
                last = self._last_stats_fb_t.get(i, -1e9)
                if self.t - last >= period:
                    self._last_stats_fb_t[i] = self.t
                    self.sc.receive_feedback(
                        Feedback(
                            i,
                            CrtsParam.RX_STATS,
                            node.radio.get_rx_stats(self.t),
                            self.t,
                        )
                    )

    # -- main loop --

    def start(self) -> None:
        for n in self.nodes:
            n.start()
        self.sc.initialize_node_fb()

    def _node_failed(self, idx: int, exc: Exception) -> None:
        """Failure detection (the reference controller's node-disconnect
        handling, src/crts_controller.cpp:43-54): halt the node, record, and
        terminate the run under the default policy."""
        self.failed_nodes[idx] = f"{type(exc).__name__}: {exc}"
        self.nodes[idx].started = False
        if self.cfg.on_node_failure == "terminate":
            self.terminated = True

    def step(self) -> None:
        n = self.medium_cfg.block_len
        dt = self.medium_cfg.block_dt
        contributions = []
        for i, node in enumerate(self.nodes):
            try:
                node.poll_traffic(self.t)
                contributions.append(node.pull_tx_block(n))
            except Exception as e:  # noqa: BLE001 - node isolation boundary
                self._node_failed(i, e)
                contributions.append(None)
        blocks = self.medium.propagate(contributions)
        for i, (node, block) in enumerate(zip(self.nodes, blocks)):
            try:
                if block is not None:
                    node.push_rx_block(block, self.t)
                elif hasattr(node, "push_rx_silence"):
                    node.push_rx_silence(n, self.t)
                node.run_ce(self.t)
                node.drain_rx_packets(self.t)
            except Exception as e:  # noqa: BLE001
                self._node_failed(i, e)
        self._collect_feedback()
        if (self.t - self._last_sc_t) * 1e3 >= self.sc.sc_timeout_ms:
            self.sc.timeout()
            self._last_sc_t = self.t
        self.t += dt

    def run(self, rep: int = 1) -> ScenarioSummary:
        import time as _time

        try:
            self.start()
            wall_start = _time.monotonic()
            # steady-state window: from a quarter into the run (kernels
            # build and caches fill over the first steps — the reference's
            # accounting, which its NetController shares)
            t_q = self.cfg.run_time / 4.0
            wall_q = None
            t_k0 = 0.0
            while self.t < self.cfg.run_time and not self.terminated:
                if wall_q is None and self.t >= t_q:
                    wall_q = _time.monotonic()
                    t_k0 = self.t
                self.step()
                if (
                    self.cfg.max_wall_time_s is not None
                    and _time.monotonic() - wall_start > self.cfg.max_wall_time_s
                ):
                    # forceful termination (crts_controller.cpp:556-577 analog)
                    self.terminated = True
            self.wall_time_s = _time.monotonic() - wall_start
            self.steady_wall_time_s = (
                _time.monotonic() - wall_q if wall_q is not None else 0.0
            )
            self.steady_t = self.t - t_k0 if wall_q is not None else 0.0
        finally:
            # end-of-run flush: batched rx scanning (rx_scan_blocks) may
            # hold tail frames; failed nodes are left alone
            for i, node in enumerate(self.nodes):
                fin = getattr(node, "finalize", None)
                if callable(fin) and i not in self.failed_nodes:
                    try:
                        fin(self.t)
                    except Exception as e:  # noqa: BLE001 - isolation
                        self._node_failed(i, e)
            for node in self.nodes:  # e.g. a UDP bridge's socket
                closer = getattr(node, "close", None)
                if callable(closer):
                    try:
                        closer()
                    except Exception:
                        pass
        bytes_sent, bytes_rcvd, frames, valid = [], [], [], []
        for node in self.nodes:
            if isinstance(node, InterfererNode) or not isinstance(node, RadioNode):
                # interferers and third-party radios have no traffic counters
                bytes_sent.append(0)
                bytes_rcvd.append(0)
                frames.append(0)
                valid.append(0)
            else:
                sent = node.traffic.packet_num * 256
                rcvd = sum(len(p) for (_, _, p) in node.rx_packets)
                st = node.radio.stats
                bytes_sent.append(sent)
                bytes_rcvd.append(rcvd)
                frames.append(len(st.records))
                valid.append(sum(1 for r in st.records if r.valid))
        return ScenarioSummary(
            self.cfg.name, rep, bytes_sent, bytes_rcvd, frames, valid
        )


def run_master(
    master: MasterConfig,
    scenario_loader,
    log_dir: str | Path | None = None,
    *,
    device: torch.device | str = "cuda",
) -> list[tuple[ScenarioSummary, dict[int, str]]]:
    """Master -> scenario -> rep loop (src/crts_controller.cpp:300-599).

    ``scenario_loader(name)`` -> ScenarioConfig (file- or registry-based);
    each run on ``device`` (see :class:`ScenarioRuntime`).  Returns each
    run's summary with its failed nodes (node index -> error), so a caller
    sees a node that the isolation boundary halted.
    """
    runs = []
    summaries = []
    for name, reps in master.scenarios:
        for rep in range(1, reps + 1):
            cfg = scenario_loader(name)
            sink = LogSink()
            rt = ScenarioRuntime(cfg, sink, device=device)
            summary = rt.run(rep)
            summaries.append(summary)
            runs.append((summary, dict(rt.failed_nodes)))
            if log_dir is not None:
                base = Path(log_dir)
                sink.save_npz(base / f"{name}_rep{rep}.npz")
                if master.octave_log_summary:
                    sink.export_octave(base / "octave" / f"{name}_rep{rep}.m")
    if log_dir is not None and master.octave_log_summary:
        _write_octave_summary(Path(log_dir) / "octave" / "summary.m", summaries)
    return runs


def _write_octave_summary(path: Path, summaries: list[ScenarioSummary]) -> None:
    """The controller's bytes_sent/received matrix (crts_controller.cpp:115-142)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    lines = []
    for s in summaries:
        tag = f"{s.scenario}_rep{s.rep}"
        lines.append(f"bytes_sent_{tag} = {list(s.bytes_sent)};")
        lines.append(f"bytes_received_{tag} = {list(s.bytes_received)};")
    path.write_text("\n".join(lines) + "\n")
