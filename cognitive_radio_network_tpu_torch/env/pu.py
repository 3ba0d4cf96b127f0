"""Primary-user channel-occupancy processes (port of ``cognitive_radio_network_tpu/env/pu.py``).

* ``markov_pu_trace``: the 3-state Markov hopper of CE_PU_MARKOV_Chain_Tx
  (hop every 5 s).  The *documented* transition matrix (README.md:70-74,
  CE_PU_MARKOV_Chain_Tx.cpp:15-26) is the default.  The C++ implementation
  has a broken guard (CE_PU_MARKOV_Chain_Tx.cpp:104/:114/:123) that
  collapses every row to P(CH1)=0.1, P(CH2)=0.9, P(CH3)=0; pass
  ``matrix=MARKOV_MATRIX_AS_IMPLEMENTED`` to replay that quirk.
* ``random_pu_trace``: uniform channel choice every 2 s
  (CE_Random_Behaviour_PU.cpp:28-69).

Traces are int32 channel *indices*.  Draws come from a ``torch.Generator``;
its stream differs from ``jax.random``'s, so traces agree with the
reference's in distribution, not draw for draw.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "PU_CHANNELS_HZ",
    "MARKOV_MATRIX_DOCUMENTED",
    "MARKOV_MATRIX_AS_IMPLEMENTED",
    "markov_pu_trace",
    "random_pu_trace",
]

# Markov PU channel plan (CE_PU_MARKOV_Chain_Tx.hpp:11-13).
PU_CHANNELS_HZ = (833e6, 836e6, 838e6)

# Rows = current channel, cols = next channel, P(next | current).
MARKOV_MATRIX_DOCUMENTED = np.array(
    [
        [0.1, 0.3, 0.6],
        [0.1, 0.5, 0.4],
        [0.1, 0.2, 0.7],
    ],
    dtype=np.float32,
)

# What CE_PU_MARKOV_Chain_Tx.cpp:97-128 actually realizes (guard quirk).
MARKOV_MATRIX_AS_IMPLEMENTED = np.array(
    [
        [0.1, 0.9, 0.0],
        [0.1, 0.9, 0.0],
        [0.1, 0.9, 0.0],
    ],
    dtype=np.float32,
)


def markov_pu_trace(
    generator: torch.Generator,
    num_hops: int,
    matrix=MARKOV_MATRIX_DOCUMENTED,
    initial_channel: int = 0,
    device=None,
) -> torch.Tensor:
    """Channel index per hop period (default period: 5 s per hop).

    Returns int32 (num_hops,) including the initial state as element 0, on
    ``device`` (default: the generator's).  One uniform draw per hop decides
    the next channel from every possible current one at once; the chain
    itself is a walk over those precomputed choices on the host.
    """
    p = np.asarray(matrix, np.float64)
    cdf = np.cumsum(p / p.sum(axis=1, keepdims=True), axis=1)
    u = torch.rand(
        max(num_hops - 1, 0), generator=generator, dtype=torch.float64, device=generator.device
    ).cpu().numpy()
    # choice[s, i] = next channel from state s at hop i (inverse-CDF draw)
    choice = np.minimum((u[None, :, None] >= cdf[:, None, :]).sum(-1), p.shape[1] - 1)
    states = [int(initial_channel)]
    for i in range(u.shape[0]):
        states.append(int(choice[states[-1], i]))
    out = torch.tensor(states, dtype=torch.int32)
    return out.to(device if device is not None else generator.device)


def random_pu_trace(
    generator: torch.Generator, num_hops: int, num_channels: int = 3
) -> torch.Tensor:
    """Uniform random channel per hop period (default period: 2 s per hop)."""
    return torch.randint(
        0, num_channels, (num_hops,), generator=generator, dtype=torch.int32,
        device=generator.device,
    )
