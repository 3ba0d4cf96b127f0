"""MLP checkpoints (port of ``cognitive_radio_network_tpu/io/checkpoint.py``).

The same ``.npz`` layout as the reference package: ``w1, b1, w2, b2`` in the
(in, out) layout plus ``feature_transform``, so a checkpoint written by
either package loads in the other.  A training state (the network, its
Adam moments and step counts) is written by :func:`save_state` under the
keys the reference's ``save_state`` gives a JAX ``TrainState`` (the paths of
its tree flattening), so a state written by either package resumes in the
other.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.signal.mlp import OccupancyMLP, params_from_numpy

__all__ = ["save_mlp", "load_mlp", "load_mlp_with_meta", "save_state", "load_state"]

_NAMES = ("w1", "b1", "w2", "b2")


def save_mlp(path: str | Path, mlp: OccupancyMLP, *, feature_transform: str = "none") -> None:
    """feature_transform records the input transform the weights were
    trained with ("none" | "log1p") so inference applies the same one."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    arrays = {name: getattr(mlp, name).detach().cpu().numpy() for name in _NAMES}
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


def save_state(path: str | Path, state) -> None:
    """A :class:`..models.train.TrainState` as a flat npz.

    The keys are those of a JAX ``TrainState(MLPParams, optax.adam state,
    int32 step)``: ``.params/.w1`` ... ``.params/.b2``,
    ``.opt_state/[0]/.count`` (int32), ``.opt_state/[0]/.mu/.w1`` ... and
    ``.opt_state/[0]/.nu/.w1`` ..., and ``.step``.  Adam's ``exp_avg`` is
    optax's ``mu``, ``exp_avg_sq`` its ``nu``, and the per-parameter
    ``step`` its one ``count``; before the first step they are zeros."""
    arrays = {}
    count = 0
    for name in _NAMES:
        p = getattr(state.params, name)
        st = state.opt.state.get(p, {})
        value = p.detach().cpu().numpy()
        arrays[f".params/.{name}"] = value
        for key, moment in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            m = st.get(moment)
            arrays[f".opt_state/[0]/.{key}/.{name}"] = (
                np.zeros_like(value) if m is None else m.detach().cpu().numpy()
            )
        if "step" in st:
            count = int(st["step"])
    arrays[".opt_state/[0]/.count"] = np.asarray(count, np.int32)
    arrays[".step"] = np.asarray(int(state.step), np.int32)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)


def load_state(path: str | Path, like):
    """Restore a state written by :func:`save_state` (or by the reference's
    ``save_state`` from a JAX ``TrainState``) into ``like``, a TrainState
    whose network has the saved shapes and whose optimizer is the
    ``torch.optim.Adam`` over it that ``make_optimizer`` makes.  The network's
    values and the optimizer's state are set in place (Adam makes its state
    lazily at its first step, so the entries are created here, the step
    count a float32 host tensor as Adam keeps it); returns ``like`` with the
    saved step."""
    with np.load(path) as d, torch.no_grad():
        count = float(d[".opt_state/[0]/.count"])
        for name in _NAMES:
            p = getattr(like.params, name)
            p.copy_(torch.as_tensor(d[f".params/.{name}"]))
            like.opt.state[p] = {
                "step": torch.tensor(count, dtype=torch.float32),
                "exp_avg": torch.as_tensor(d[f".opt_state/[0]/.mu/.{name}"]).to(p),
                "exp_avg_sq": torch.as_tensor(d[f".opt_state/[0]/.nu/.{name}"]).to(p),
            }
        step = int(d[".step"])
    return like._replace(step=step)
