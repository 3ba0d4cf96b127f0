"""SC_Template port: logs every feedback type at debug levels; no feedback
enabled by default (scenario_controllers/SC_Template/SC_Template.cpp:29-115)."""

from __future__ import annotations

from cognitive_radio_network_tpu_torch.runtime.engine import register_controller
from cognitive_radio_network_tpu_torch.runtime.scenario import ScenarioController, SCEvent

__all__ = ["SCTemplate"]


@register_controller("SC_Template")
class SCTemplate(ScenarioController):
    def __init__(self, args=None):
        super().__init__(args)
        self.debug_level = 0
        it = iter(self.args)
        for a in it:
            if a == "-d":
                self.debug_level = int(next(it, 0))
        self.feedback_log = []

    def execute(self) -> None:
        if self.sc_event == SCEvent.FEEDBACK and self.fb is not None:
            self.feedback_log.append(self.fb)
            if self.debug_level > 0:
                print(f"[SC_Template] fb node={self.fb.node} {self.fb.param}")
