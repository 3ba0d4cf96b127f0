"""Recorded-IQ captures with resumable cursors, MLP checkpoints and training-state
snapshots."""

from cognitive_radio_network_tpu_torch.io.checkpoint import (
    load_mlp,
    load_mlp_with_meta,
    load_state,
    save_mlp,
    save_state,
)
from cognitive_radio_network_tpu_torch.io.iq import IQReader, IQWriter, StreamCursor

__all__ = [
    "IQReader",
    "IQWriter",
    "StreamCursor",
    "save_mlp",
    "load_mlp",
    "load_mlp_with_meta",
    "save_state",
    "load_state",
]
