"""OFDM PHY: the ofdmflexframe-equivalent link, in PyTorch.

Port of ``cognitive_radio_network_tpu/phy`` (the fixed-configuration link
and the adaptive ``StreamReceiver``).  Re-creates the
capability of liquid-dsp's ``ofdmflexframegen`` / ``ofdmflexframesync``
(the external C library the reference's radio runtime is built on): CRC,
FEC, constellation mod/demod, pilot/null subcarrier allocation, frame
generation, a batched block-oriented frame synchronizer and a streaming
receiver that adapts to each frame's PHY header (and a bank of such
streams received in one device step), producing
``FrameSyncStats`` records (the contract of the vendored
framesyncstats.c:39-55).
"""

from cognitive_radio_network_tpu_torch.phy import bits, crc, fec, modem, subcarriers
from cognitive_radio_network_tpu_torch.phy.framegen import OFDMFrameConfig, OFDMFrameGen
from cognitive_radio_network_tpu_torch.phy.framesync import (
    FrameSyncStats,
    OFDMFrameSync,
    StreamReceiver,
)
from cognitive_radio_network_tpu_torch.phy.stream import StreamBank

__all__ = [
    "bits",
    "crc",
    "fec",
    "modem",
    "subcarriers",
    "OFDMFrameConfig",
    "OFDMFrameGen",
    "OFDMFrameSync",
    "FrameSyncStats",
    "StreamReceiver",
    "StreamBank",
]
