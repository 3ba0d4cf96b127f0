"""MLP checkpoints (port of ``cognitive_radio_network_tpu/io/checkpoint.py``).

The same ``.npz`` layout as the reference package: ``w1, b1, w2, b2`` in the
(in, out) layout plus ``feature_transform``, so a checkpoint written by
either package loads in the other.  Optimizer-state snapshots
(``save_state``/``load_state``) come with training.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.signal.mlp import OccupancyMLP, params_from_numpy

__all__ = ["save_mlp", "load_mlp", "load_mlp_with_meta"]


def save_mlp(path: str | Path, mlp: OccupancyMLP, *, feature_transform: str = "none") -> None:
    """feature_transform records the input transform the weights were
    trained with ("none" | "log1p") so inference applies the same one."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    arrays = {name: getattr(mlp, name).detach().cpu().numpy() for name in ("w1", "b1", "w2", "b2")}
    np.savez(path, **arrays, feature_transform=np.asarray(feature_transform))


def load_mlp(path: str | Path, device=None, dtype=torch.float32) -> OccupancyMLP:
    return load_mlp_with_meta(path, device, dtype)[0]


def load_mlp_with_meta(
    path: str | Path, device=None, dtype=torch.float32
) -> tuple[OccupancyMLP, dict]:
    with np.load(path) as d:
        mlp = params_from_numpy(d["w1"], d["b1"], d["w2"], d["b2"], device=device, dtype=dtype)
        meta = {
            "feature_transform": (
                str(d["feature_transform"]) if "feature_transform" in d else "none"
            )
        }
    return mlp, meta
