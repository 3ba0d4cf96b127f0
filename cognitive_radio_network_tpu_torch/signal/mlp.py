"""The 4-5-3 sigmoid occupancy MLP (port of ``cognitive_radio_network_tpu/signal/mlp.py``).

The reference hard-codes trained weights in source (CE_Predictive_Node.cpp:78-120)
and runs the forward pass as scalar loops with 1-based indexing where row 0
of each weight table is the bias (CE_Predictive_Node.cpp:214-235).  Here the
network is an ``nn.Module`` whose parameters keep the JAX package's layout,
so weights move between the packages as they are:

  w1[i-1, j-1] = WeightIH[i][j]   (i=1..4 inputs, j=1..5 hidden)
  b1[j-1]      = WeightIH[0][j]
  w2[j-1, k-1] = WeightHO[j][k]   (j=1..5 hidden, k=1..3 outputs)
  b2[k-1]      = WeightHO[0][k]

Input order: [noise_floor, ch1, ch2, ch3] (CE_Predictive_Node.cpp:200).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cognitive_radio_network_tpu_torch.utils.device import full_f32

__all__ = [
    "OccupancyMLP",
    "reference_weights",
    "params_from_numpy",
    "mlp_apply",
    "mlp_forward",
    "init_mlp",
]

# WeightIH[i][j] transposed into (input, hidden): rows i=1..4, cols j=1..5.
_REF_W1 = np.array(
    [
        # j=1        j=2        j=3        j=4        j=5
        [-0.106634, -0.415470, 0.309261, 0.159974, 0.212781],  # i=1 (NF)
        [0.005650, 0.741944, 0.006133, -0.620100, 0.669892],  # i=2 (CH1)
        [-0.057578, 0.621154, -0.048268, -0.249186, 0.734475],  # i=3 (CH2)
        [0.092680, 0.809336, -0.010821, -0.546496, 0.609384],  # i=4 (CH3)
    ],
    dtype=np.float64,
)
_REF_B1 = np.array(
    [-0.188208, -0.170684, -0.024726, 0.001448, 0.015983], dtype=np.float64
)
# WeightHO[j][k]: rows j=1..5, cols k=1..3.
_REF_W2 = np.array(
    [
        # k=1        k=2         k=3
        [10.857465, -18.452471, 15.609466],  # j=1
        [-6.848443, 2.053071, -2.929559],  # j=2
        [17.053079, -13.375309, -15.703407],  # j=3
        [0.087664, -0.269499, 0.407028],  # j=4
        [-6.552455, 2.655529, -2.552555],  # j=5
    ],
    dtype=np.float64,
)
_REF_B2 = np.array([-7.033320, 2.726400, -2.590206], dtype=np.float64)


def mlp_apply(features, w1, b1, w2, b2) -> torch.Tensor:
    """CE_Predictive_Node.cpp:214-235 on weight tensors: sigmoid hidden +
    sigmoid output, in the weights' dtype, with TF32 off."""
    x = features.to(w1.dtype)
    with full_f32():
        h = torch.sigmoid(torch.matmul(x, w1) + b1)
        return torch.sigmoid(torch.matmul(h, w2) + b2)


class OccupancyMLP(nn.Module):
    """Sigmoid MLP (..., n_in) -> (..., n_out) in [0, 1], weights (in, out)."""

    def __init__(
        self, n_in: int = 4, n_hidden: int = 5, n_out: int = 3, *, device=None, dtype=torch.float32
    ):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.w1 = nn.Parameter(torch.zeros(n_in, n_hidden, **kw))
        self.b1 = nn.Parameter(torch.zeros(n_hidden, **kw))
        self.w2 = nn.Parameter(torch.zeros(n_hidden, n_out, **kw))
        self.b2 = nn.Parameter(torch.zeros(n_out, **kw))

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        """CE_Predictive_Node.cpp:214-235: sigmoid hidden + sigmoid output."""
        return mlp_apply(features, self.w1, self.b1, self.w2, self.b2)


def params_from_numpy(w1, b1, w2, b2, *, device=None, dtype=torch.float32) -> OccupancyMLP:
    """An :class:`OccupancyMLP` holding the given arrays (the JAX ``MLPParams``
    fields as numpy), cast to ``dtype`` on ``device``."""
    w1, b1, w2, b2 = (np.array(v) for v in (w1, b1, w2, b2))  # writable copies
    mlp = OccupancyMLP(w1.shape[0], w1.shape[1], w2.shape[1], device=device, dtype=dtype)
    with torch.no_grad():
        for p, v in zip((mlp.w1, mlp.b1, mlp.w2, mlp.b2), (w1, b1, w2, b2)):
            p.copy_(torch.as_tensor(v, dtype=dtype))
    return mlp


def reference_weights(device=None, dtype=torch.float32) -> OccupancyMLP:
    """The reference's trained 4-5-3 weights (CE_Predictive_Node.cpp:78-120)."""
    return params_from_numpy(_REF_W1, _REF_B1, _REF_W2, _REF_B2, device=device, dtype=dtype)


def mlp_forward(mlp: OccupancyMLP, features: torch.Tensor) -> torch.Tensor:
    """Sigmoid MLP forward pass: (..., n_in) -> (..., n_out) in [0, 1]."""
    return mlp(features)


def init_mlp(
    generator: torch.Generator,
    n_in: int = 4,
    n_hidden: int = 5,
    n_out: int = 3,
    *,
    dtype=torch.float32,
) -> OccupancyMLP:
    """Fresh trainable parameters on the generator's device: Glorot-uniform
    weights in ``+-sqrt(6 / (in + out))``, (in, out) layout, zero biases."""
    mlp = OccupancyMLP(n_in, n_hidden, n_out, device=generator.device, dtype=dtype)
    with torch.no_grad():
        for w, fan in ((mlp.w1, n_in + n_hidden), (mlp.w2, n_hidden + n_out)):
            s = float(np.sqrt(6.0 / fan))
            w.uniform_(-s, s, generator=generator)
    return mlp
