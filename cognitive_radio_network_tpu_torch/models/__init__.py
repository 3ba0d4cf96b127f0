"""The sense->classify pipeline (training is not ported yet)."""

from cognitive_radio_network_tpu_torch.models.sense import (
    SenseConfig,
    make_sense_fn,
    sense_classify,
    sense_classify_trace,
)

__all__ = ["SenseConfig", "sense_classify", "sense_classify_trace", "make_sense_fn"]
