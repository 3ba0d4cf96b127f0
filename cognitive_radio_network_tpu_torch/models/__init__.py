"""The sense->classify pipeline, classifier training, and the wideband train
and apply steps."""

from cognitive_radio_network_tpu_torch.models.distributed import (
    make_sharded_apply,
    make_sharded_train_step,
    wideband_features,
)
from cognitive_radio_network_tpu_torch.models.sense import (
    SenseConfig,
    make_sense_fn,
    sense_classify,
    sense_classify_trace,
)
from cognitive_radio_network_tpu_torch.models.train import (
    TrainConfig,
    TrainState,
    fit,
    make_dataset,
    train_step,
)

__all__ = [
    "SenseConfig",
    "sense_classify",
    "sense_classify_trace",
    "make_sense_fn",
    "TrainConfig",
    "TrainState",
    "make_dataset",
    "train_step",
    "fit",
    "wideband_features",
    "make_sharded_train_step",
    "make_sharded_apply",
]
