"""Synthetic RF environment: PU hopping processes, channel impairments,
interferer waveforms (``InterfererConfig``, ``synthesize_interference``) and
scene composition."""

from cognitive_radio_network_tpu_torch.env.channel import awgn, mix_to_offset
from cognitive_radio_network_tpu_torch.env.interference import (
    InterfererConfig,
    synthesize_interference,
)
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
    "InterfererConfig",
    "synthesize_interference",
    "awgn",
    "mix_to_offset",
    "SceneConfig",
    "synthesize_scene",
    "occupancy_to_powers",
]
