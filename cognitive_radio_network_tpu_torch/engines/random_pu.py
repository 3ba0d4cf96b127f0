"""CE_Random_Behaviour_PU port: every 2 s, uniformly random channel among
833/835/838 MHz (CE_Random_Behaviour_PU.cpp:28-69; channels .hpp:21-23).
The reference stores the frequency through an int (truncation quirk,
:49) and its channel guard is tautological (:53) — both are simply
correct here."""

from __future__ import annotations

import numpy as np

from cognitive_radio_network_tpu_torch.runtime.engine import CognitiveEngine, register_engine

__all__ = ["CERandomPU"]


@register_engine("CE_Random_Behaviour_PU")
class CERandomPU(CognitiveEngine):
    period_s = 2.0
    channels = (833e6, 835e6, 838e6)

    def __init__(self, radio, args=None):
        super().__init__(radio, args)
        self.first_execution = True
        self.switch_time_s = 0.0
        self.rng = np.random.default_rng(0xB0B)

    def execute(self) -> None:
        t = self.radio.CE_metrics.time_s
        if self.first_execution:
            self.radio.stop_rx()
            self.switch_time_s = t + self.period_s
            self.first_execution = False
        if t >= self.switch_time_s:
            self.switch_time_s += self.period_s
            self.radio.set_tx_freq(self.channels[int(self.rng.integers(0, 3))])
