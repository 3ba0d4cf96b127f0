"""Numerics core: the sensing math of the reference, in PyTorch.

Port of ``cognitive_radio_network_tpu/signal`` with the same numerical
contracts (CE_Predictive_Node.cpp:146-235).  ``msequence`` (the PRBS of the
OFDM preambles and pilots) is imported by its module path.  Resampling is
not ported yet.
"""

from cognitive_radio_network_tpu_torch.signal import filters
from cognitive_radio_network_tpu_torch.signal.bands import (
    DEFAULT_BANDS,
    SensingBands,
    band_features,
    band_matrix,
)
from cognitive_radio_network_tpu_torch.signal.channelizer import (
    channelize,
    channelize_planes,
    polyphase_taps,
)
from cognitive_radio_network_tpu_torch.signal.detector import (
    DECISION_ALL_BUSY,
    SU_CHANNELS_HZ,
    next_tx_channel,
    occupancy_decision,
)
from cognitive_radio_network_tpu_torch.signal.fft import (
    averaged_magnitude_spectrum,
    dft_matrices,
    spectrum_magnitude,
)
from cognitive_radio_network_tpu_torch.signal.iq import (
    from_planes,
    planes_abs2,
    split_iq,
    to_planes,
)
from cognitive_radio_network_tpu_torch.signal.mlp import (
    OccupancyMLP,
    mlp_forward,
    params_from_numpy,
    reference_weights,
)

__all__ = [
    "dft_matrices",
    "spectrum_magnitude",
    "averaged_magnitude_spectrum",
    "SensingBands",
    "DEFAULT_BANDS",
    "band_matrix",
    "band_features",
    "OccupancyMLP",
    "reference_weights",
    "params_from_numpy",
    "mlp_forward",
    "occupancy_decision",
    "next_tx_channel",
    "DECISION_ALL_BUSY",
    "SU_CHANNELS_HZ",
    "to_planes",
    "from_planes",
    "split_iq",
    "planes_abs2",
    "filters",
    "polyphase_taps",
    "channelize",
    "channelize_planes",
]
