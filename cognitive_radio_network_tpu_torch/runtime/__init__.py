"""Node + scenario runtime: the host-side orchestration layer.

Replaces the reference's multi-process TCP/ssh control plane
(SURVEY.md §2.2, §2.5) with an in-process simulation runtime: typed configs,
block-stepped medium, event-driven engines, scenario controllers, traffic
models, sliding-window statistics, and structured logging with Octave export.

Port of ``cognitive_radio_network_tpu/runtime``: the in-process runtime,
with its device work on the caller's ``device`` (the card by default).  The
reference's multi-process runtime (netctl) and process-isolated radios
(procradio) are not ported yet.
"""

from cognitive_radio_network_tpu_torch.runtime.engine import (
    CEEvent,
    CEMetrics,
    CognitiveEngine,
    create_engine,
    engine_names,
    register_engine,
    create_controller,
    controller_names,
    register_controller,
)
from cognitive_radio_network_tpu_torch.runtime.radio import Radio, RadioParams
from cognitive_radio_network_tpu_torch.runtime.stats import RxStatistics, RxStats
from cognitive_radio_network_tpu_torch.runtime.traffic import TrafficConfig, TrafficSource
from cognitive_radio_network_tpu_torch.runtime.medium import Medium, MediumConfig
from cognitive_radio_network_tpu_torch.runtime.node import RadioNode, InterfererNode
from cognitive_radio_network_tpu_torch.runtime.scenario import (
    ScenarioController,
    SCEvent,
    CrtsParam,
    Feedback,
)
from cognitive_radio_network_tpu_torch.runtime.config import (
    MasterConfig,
    NodeConfig,
    ScenarioConfig,
    load_master,
    load_scenario,
    parse_cfg,
    scenario_from_dict,
)
from cognitive_radio_network_tpu_torch.runtime.controller import (
    ScenarioRuntime,
    ScenarioSummary,
    run_master,
)
from cognitive_radio_network_tpu_torch.runtime.logging import LogSink

__all__ = [
    "CEEvent",
    "CEMetrics",
    "CognitiveEngine",
    "create_engine",
    "engine_names",
    "register_engine",
    "create_controller",
    "controller_names",
    "register_controller",
    "Radio",
    "RadioParams",
    "RxStatistics",
    "RxStats",
    "TrafficConfig",
    "TrafficSource",
    "Medium",
    "MediumConfig",
    "RadioNode",
    "InterfererNode",
    "ScenarioController",
    "SCEvent",
    "CrtsParam",
    "Feedback",
    "MasterConfig",
    "NodeConfig",
    "ScenarioConfig",
    "load_master",
    "load_scenario",
    "parse_cfg",
    "scenario_from_dict",
    "ScenarioRuntime",
    "ScenarioSummary",
    "run_master",
    "LogSink",
]
