"""OFDM PHY: the ofdmflexframe-equivalent link, in PyTorch.

Port of ``cognitive_radio_network_tpu/phy`` (the fixed-configuration link;
the adaptive ``StreamReceiver`` is not ported yet).  Re-creates the
capability of liquid-dsp's ``ofdmflexframegen`` / ``ofdmflexframesync``
(the external C library the reference's radio runtime is built on): CRC,
FEC, constellation mod/demod, pilot/null subcarrier allocation, frame
generation, and a batched block-oriented frame synchronizer producing
``FrameSyncStats`` records (the contract of the vendored
framesyncstats.c:39-55).
"""

from cognitive_radio_network_tpu_torch.phy import bits, crc, fec, modem, subcarriers
from cognitive_radio_network_tpu_torch.phy.framegen import OFDMFrameConfig, OFDMFrameGen
from cognitive_radio_network_tpu_torch.phy.framesync import FrameSyncStats, OFDMFrameSync

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
]
