"""Synthetic RF environment: PU hopping processes, channel impairments and
scene composition.  The interferer waveforms (``env.interference``) are
imported by their module path."""

from cognitive_radio_network_tpu_torch.env.channel import awgn, mix_to_offset
from cognitive_radio_network_tpu_torch.env.pu import (
    MARKOV_MATRIX_AS_IMPLEMENTED,
    MARKOV_MATRIX_DOCUMENTED,
    PU_CHANNELS_HZ,
    markov_pu_trace,
    random_pu_trace,
)
from cognitive_radio_network_tpu_torch.env.scene import (
    SceneConfig,
    occupancy_to_powers,
    synthesize_scene,
)

__all__ = [
    "MARKOV_MATRIX_DOCUMENTED",
    "MARKOV_MATRIX_AS_IMPLEMENTED",
    "PU_CHANNELS_HZ",
    "markov_pu_trace",
    "random_pu_trace",
    "awgn",
    "mix_to_offset",
    "SceneConfig",
    "synthesize_scene",
    "occupancy_to_powers",
]
