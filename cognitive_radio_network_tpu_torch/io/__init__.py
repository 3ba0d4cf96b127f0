"""Recorded-IQ captures with resumable cursors, and MLP checkpoints."""

from cognitive_radio_network_tpu_torch.io.checkpoint import load_mlp, load_mlp_with_meta, save_mlp
from cognitive_radio_network_tpu_torch.io.iq import IQReader, IQWriter, StreamCursor

__all__ = [
    "IQReader",
    "IQWriter",
    "StreamCursor",
    "save_mlp",
    "load_mlp",
    "load_mlp_with_meta",
]
