"""CE_Template port: the tutorial engine that switches on every event type
(cognitive_engines/CE_Template/CE_Template.cpp:31-60), with getopt-style
``ce_args`` parsing (-d debug level)."""

from __future__ import annotations

from cognitive_radio_network_tpu_torch.runtime.engine import (
    CEEvent,
    CognitiveEngine,
    register_engine,
)

__all__ = ["CETemplate"]


@register_engine("CE_Template")
class CETemplate(CognitiveEngine):
    def __init__(self, radio, args=None):
        super().__init__(radio, args)
        self.debug_level = 0
        it = iter(self.args)
        for a in it:
            if a == "-d":
                self.debug_level = int(next(it, 0))
        self.event_counts: dict[CEEvent, int] = {e: 0 for e in CEEvent}

    def execute(self) -> None:
        ev = self.radio.CE_metrics.ce_event
        self.event_counts[ev] += 1
        if self.debug_level > 0:
            print(f"[CE_Template] event={ev.name}")
