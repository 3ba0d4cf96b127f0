"""CE_TX_CHANNEL_X port: transmit on an operator-chosen channel
(CE_TX_CHANNEL_X.cpp:13-24 reads the channel from stdin once; here it comes
from ``ce_args`` — e.g. ``"-c 2"`` — since the runtime is non-interactive)."""

from __future__ import annotations

from cognitive_radio_network_tpu_torch.runtime.engine import CognitiveEngine, register_engine

__all__ = ["CETxChannelX"]


@register_engine("CE_TX_CHANNEL_X")
class CETxChannelX(CognitiveEngine):
    channels = (833e6, 835e6, 838e6)

    def __init__(self, radio, args=None):
        super().__init__(radio, args)
        self.channel = 1
        it = iter(self.args)
        for a in it:
            if a == "-c":
                self.channel = int(next(it, 1))
        self.configured = False

    def execute(self) -> None:
        if not self.configured:
            self.radio.set_tx_freq(self.channels[(self.channel - 1) % 3])
            self.configured = True
