"""CE_Predictive_Node port — the north-star secondary-user engine.

Sense->classify loop of cognitive_engines/CE_Predictive_Node/CE_Predictive_Node.cpp:
(1) one-time config: stop tx, tune rx to fc=833 MHz / 13 MS/s, load the
    trained 4-5-3 MLP weights (:66-123);
(2) every sensing_delay_ms=100 ms: stop tx, enable the raw-sample sensing
    tap (:131-141);
(3) per USRP_RX_SAMPS event: 512-pt FFT, accumulate |X|/10 (:146-155);
(4) after 10 buffers: band energies -> features -> sigmoid MLP -> threshold
    0.8 decision -> retune tx to a free channel (:157-261), reset (:287-288).

Port of ``cognitive_radio_network_tpu/engines/predictive_node.py``: steps
(3)-(4) are one ``models.sense.sense_classify`` call per completed averaging
cycle on the radio's device, where the FFT, the magnitude average, the band
features, the MLP and the decision are one launch of the classify form of the
sense kernel (``fused_sense_classify``, on the card).
The MLP is placed on that device once, at construction; the ten buffers go
up in one copy and the decision comes back in one read, which the engine
needs to act on.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.models.sense import SenseConfig, make_sense_fn
from cognitive_radio_network_tpu_torch.runtime.engine import (
    CEEvent,
    CognitiveEngine,
    register_engine,
)
from cognitive_radio_network_tpu_torch.signal.detector import next_tx_channel
from cognitive_radio_network_tpu_torch.signal.mlp import reference_weights

__all__ = ["CEPredictiveNode"]


@register_engine("CE_Predictive_Node")
class CEPredictiveNode(CognitiveEngine):
    desired_fc = 833e6  # CE_Predictive_Node.hpp:42
    desired_bw = 13e6  # .hpp:43

    def __init__(self, radio, args=None):
        super().__init__(radio, args)
        self.device = radio.device
        self.cfg = SenseConfig()
        # ce_args: -w <checkpoint.npz> loads trained weights (the reference
        # hardcodes its weights in source, CE_Predictive_Node.cpp:78-120;
        # checkpoints of either package load here: io/checkpoint.py)
        a = list(args or [])
        if "-w" in a:
            from cognitive_radio_network_tpu_torch.io.checkpoint import load_mlp_with_meta

            self.params, meta = load_mlp_with_meta(a[a.index("-w") + 1], device=self.device)
            self.cfg = dataclasses.replace(
                self.cfg, feature_transform=meta["feature_transform"]
            )
        else:
            self.params = reference_weights(device=self.device)
        # the parameters live on the sensing device from here on, so a
        # classify copies none (make_sense_fn copies parameters found
        # elsewhere on every call)
        self._sense_fn = make_sense_fn(self.cfg, device=self.device)
        # sensing-only mode (default): stop the frame synchronizer while
        # this engine senses — the reference carries exactly this line,
        # commented, with the note that stopping rx relates to forwarding
        # samples to the CE (CE_Predictive_Node.cpp:136
        # ``//ECR->stop_rx(); /*stopping rx enables forwarding samples to
        # CE*/``), and the predictive SU never expects PHY frames (the PU
        # transmits at an incompatible rate).  ``--keep-framesync`` in
        # ce_args restores the reference's literal keep-rx-running
        # behavior (identical decisions either way; frame scanning on an
        # undecodable stream is pure cost).
        self.sense_only = "--keep-framesync" not in (args or [])
        self.configured = False
        self.next_sense_t = 0.0
        self.collecting = False
        self.buffers: list[np.ndarray] = []
        self.decisions: list[int] = []
        # MLP outputs per classify, (3,) tensors left on the sensing device
        # (reading them would cost a second device-to-host copy per classify)
        self.outputs: list[torch.Tensor] = []

    def execute(self) -> None:
        r = self.radio
        t = r.CE_metrics.time_s
        if not self.configured:
            r.stop_tx()
            r.set_rx_freq(self.desired_fc)
            r.set_rx_rate(self.desired_bw)
            r.set_ce_usrp_rx_buffer_length(self.cfg.fft_length)
            if self.sense_only:
                r.stop_rx()  # CE_Predictive_Node.cpp:136 (see __init__)
            self.configured = True
            self.next_sense_t = t

        if t >= self.next_sense_t and not self.collecting:
            r.stop_tx()
            r.set_ce_sensing(1)
            self.collecting = True
            self.next_sense_t = t + self.cfg.sensing_delay_ms / 1e3

        if r.CE_metrics.ce_event == CEEvent.USRP_RX_SAMPS and self.collecting:
            buf = np.asarray(r.CE_metrics.payload)
            self.buffers.append(buf[: self.cfg.fft_length])
            if len(self.buffers) == self.cfg.averaging:
                r.set_ce_sensing(0)
                self.collecting = False
                self._classify_and_act()
                self.buffers.clear()

    @torch.no_grad()
    def _classify_and_act(self) -> None:
        r = self.radio
        stack = np.stack(self.buffers)  # (A, N) complex64
        host = np.stack([stack.real, stack.imag]).astype(np.float32)  # (2, A, N)
        planes = torch.from_numpy(host).to(self.device)  # the cycle's one upload
        res = self._sense_fn((planes[0], planes[1]), self.params)
        decision = int(res["decision"][0].item())  # the one read: the engine acts on it
        self.decisions.append(decision)
        self.outputs.append(res["outputs"][0])
        new_freq = float(
            next_tx_channel(
                torch.tensor(decision), np.float32(r.get_tx_freq()), self.cfg.channels_hz
            )
        )
        if decision != 0:
            r.set_tx_freq(new_freq)
        # else: "ALL BUSY, SENSE AND OBSERVE AGAIN" (CE_Predictive_Node.cpp:261)
