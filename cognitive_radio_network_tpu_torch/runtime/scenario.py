"""Scenario-controller protocol.

Port of the SC plug-in API (include/scenario_controller.hpp:26-57,
src/scenario_controller.cpp): a controller-side policy object with the same
event model as cognitive engines — TIMEOUT vs FEEDBACK events, a
``set_node_parameter`` control channel into any node, and per-parameter
feedback enables (the CRTS_..._FB_EN bitmask, include/crts.hpp:247-260).

Port of ``cognitive_radio_network_tpu/runtime/scenario.py``, copied.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

__all__ = ["SCEvent", "Feedback", "ScenarioController", "CrtsParam"]


class SCEvent(enum.Enum):
    TIMEOUT = 0
    FEEDBACK = 1


class CrtsParam(enum.Enum):
    """The 27-entry control/feedback parameter registry
    (enum crts_params, include/crts.hpp:209-244)."""

    TX_STATE = 0
    TX_FREQ = 1
    TX_RATE = 2
    TX_GAIN = 3
    TX_MOD = 4
    TX_CRC = 5
    TX_FEC0 = 6
    TX_FEC1 = 7
    RX_STATE = 8
    RX_RESET = 9
    RX_FREQ = 10
    RX_RATE = 11
    RX_GAIN = 12
    RX_STATS = 13
    RX_STATS_FB = 14
    RX_STATS_RESET = 15
    NET_THROUGHPUT = 16
    NET_TRAFFIC_TYPE = 17
    FB_EN = 18
    TX_DUTY_CYCLE = 19
    TX_PERIOD = 20
    TX_FREQ_BEHAVIOR = 21
    TX_FREQ_MIN = 22
    TX_FREQ_MAX = 23
    TX_FREQ_DWELL_TIME = 24
    TX_FREQ_RES = 25
    UNKNOWN = 26


@dataclasses.dataclass
class Feedback:
    node: int
    param: CrtsParam
    value: Any
    time_s: float


class ScenarioController:
    """Base SC. The scenario runtime calls execute() on feedback arrival
    (receive_feedback invokes execute inline, src/scenario_controller.cpp:30-38)
    and on sc_timeout_ms expiry."""

    def __init__(self, args: list[str] | None = None):
        self.args = args or []
        self.sc_event = SCEvent.TIMEOUT
        self.fb: Feedback | None = None
        self.runtime = None  # set by the scenario runtime
        self.sc_timeout_ms = 1000.0
        # node -> bitmask of enabled feedback params
        self.fb_enables: dict[int, int] = {}

    # -- API available to subclasses (scenario_controller.hpp:26-57) --

    def set_node_parameter(self, node: int, param: CrtsParam, value) -> None:
        self.runtime.apply_control(node, param, value)

    def enable_feedback(self, node: int, mask: int) -> None:
        self.fb_enables[node] = mask

    def get_feedback_enables(self, node: int) -> int:
        return self.fb_enables.get(node, 0)

    # -- hooks --

    def initialize_node_fb(self) -> None:  # called before start
        pass

    def execute(self) -> None:  # pragma: no cover - policy hook
        pass

    def receive_feedback(self, fb: Feedback) -> None:
        self.sc_event = SCEvent.FEEDBACK
        self.fb = fb
        self.execute()

    def timeout(self) -> None:
        self.sc_event = SCEvent.TIMEOUT
        self.fb = None
        self.execute()
