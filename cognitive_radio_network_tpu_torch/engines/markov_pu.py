"""CE_PU_MARKOV_Chain_Tx port: Markov-chain primary-user transmitter.

Every ``period_s`` = 5 s the engine hops its tx center frequency among
CH1=833e6, CH2=836e6, CH3=838e6 by a 3-state Markov chain
(CE_PU_MARKOV_Chain_Tx.cpp:46-128; channels .hpp:11-13).  It stops rx on
first execute and sets the CE timeout to 100 ms (:48-58).

Matrix modes:
* ``documented`` (default): the transition matrix from README.md:70-74 /
  the source-comment table (CE_PU_MARKOV_Chain_Tx.cpp:15-26);
* ``as-implemented``: replays the C++ guard quirk
  (``state_probability>=1 || state_probability<4`` is always true for
  outcome >= 1, :104/:114/:123), i.e. P(CH1)=0.1, P(CH2)=0.9 from any state.
Select with ``ce_args = "-m as-implemented"``.
"""

from __future__ import annotations

import numpy as np

from cognitive_radio_network_tpu_torch.env.pu import (
    MARKOV_MATRIX_AS_IMPLEMENTED,
    MARKOV_MATRIX_DOCUMENTED,
    PU_CHANNELS_HZ,
)
from cognitive_radio_network_tpu_torch.runtime.engine import CognitiveEngine, register_engine

__all__ = ["CEMarkovPU"]


@register_engine("CE_PU_MARKOV_Chain_Tx")
class CEMarkovPU(CognitiveEngine):
    period_s = 5.0
    channels = PU_CHANNELS_HZ

    def __init__(self, radio, args=None):
        super().__init__(radio, args)
        matrix_mode = "documented"
        it = iter(self.args)
        for a in it:
            if a == "-m":
                matrix_mode = next(it, "documented")
            elif a == "-p":
                self.period_s = float(next(it, self.period_s))
        self.matrix = (
            MARKOV_MATRIX_AS_IMPLEMENTED
            if matrix_mode == "as-implemented"
            else MARKOV_MATRIX_DOCUMENTED
        )
        self.first_execution = True
        self.rx_flag = True
        self.switch_time_s = 0.0
        self.hopping = 0
        self.rng = np.random.default_rng(0xA57)

    def _current_state(self) -> int:
        f = self.radio.get_tx_freq()
        for i, c in enumerate(self.channels):
            if f == c:
                return i
        return 2  # reference: final else treats anything else as CH3

    def execute(self) -> None:
        t = self.radio.CE_metrics.time_s
        if self.rx_flag:
            self.radio.stop_rx()
            self.rx_flag = False
        if self.first_execution:
            self.switch_time_s = t + self.period_s
            self.radio.set_ce_timeout_ms(100.0)
            self.first_execution = False
        if t >= self.switch_time_s:
            self.switch_time_s += self.period_s
            self.hopping += 1
            state = self._current_state()
            nxt = int(self.rng.choice(3, p=self.matrix[state]))
            self.radio.set_tx_freq(self.channels[nxt])
