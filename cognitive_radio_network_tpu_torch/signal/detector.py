"""Occupancy decision + channel-switch policy (port of
``cognitive_radio_network_tpu/signal/detector.py``).

Reproduces the decision chain of CE_Predictive_Node.cpp:245-261:

    if      Output[1] >= 0.8:  CH1 occupied -> retune tx to CHANNEL2 (835 MHz)
    elif    Output[2] >= 0.8:  CH2 occupied -> retune tx to CHANNEL1 (833 MHz)
    elif    Output[3] >= 0.8:  CH3 occupied -> retune tx to CHANNEL2 (835 MHz)
    else:   "ALL BUSY, SENSE AND OBSERVE AGAIN" (keep current tx freq)

The if/elif *priority* matters (the reference never evaluates Output[2] when
Output[1] fired), and the "else" branch keeps the radio where it is.
"""

from __future__ import annotations

import torch

__all__ = [
    "DECISION_ALL_BUSY",
    "SU_CHANNELS_HZ",
    "occupancy_decision",
    "next_tx_channel",
    "tx_freq_trace",
]

# Secondary-user channel plan (CE_Predictive_Node.hpp:55-57).
SU_CHANNELS_HZ = (833e6, 835e6, 838e6)

DECISION_ALL_BUSY = 0  # decision code when no output crosses the threshold


def occupancy_decision(outputs: torch.Tensor, threshold: float = 0.8) -> torch.Tensor:
    """First output >= threshold, 1-indexed; 0 = all busy / sense again.

    outputs: (..., 3) MLP activations. Returns int32 (...,) in {0, 1, 2, 3}.
    """
    o1, o2, o3 = outputs[..., 0], outputs[..., 1], outputs[..., 2]
    busy = torch.full_like(o1, DECISION_ALL_BUSY, dtype=torch.int32)
    return torch.where(
        o1 >= threshold,
        1,
        torch.where(o2 >= threshold, 2, torch.where(o3 >= threshold, 3, busy)),
    ).to(torch.int32)


def next_tx_channel(
    decision: torch.Tensor,
    current_freq_hz,
    channels_hz: tuple[float, float, float] = SU_CHANNELS_HZ,
) -> torch.Tensor:
    """Map a decision code to the next tx center frequency (float32).

    decision 1 -> channels[1] (835e6); 2 -> channels[0] (833e6);
    3 -> channels[1] (835e6); 0 -> keep current frequency.
    """
    ch1, ch2, _ = channels_hz
    cur = torch.as_tensor(current_freq_hz, dtype=torch.float32, device=decision.device)
    cur = torch.broadcast_to(cur, decision.shape)
    table = torch.stack(
        [
            cur,  # 0: all busy -> keep
            torch.full_like(cur, ch2),  # 1: CH1 occupied -> go to CH2
            torch.full_like(cur, ch1),  # 2: CH2 occupied -> go to CH1
            torch.full_like(cur, ch2),  # 3: CH3 occupied -> go to CH2
        ],
        dim=-1,
    )
    return torch.take_along_dim(table, decision.long()[..., None], dim=-1)[..., 0]


def tx_freq_trace(
    decision: torch.Tensor,
    initial_tx_freq_hz,
    channels_hz: tuple[float, float, float] = SU_CHANNELS_HZ,
) -> torch.Tensor:
    """tx_freq[c] = next_tx_channel applied over decision[0..c], vectorized
    (the reference's ``lax.scan``, CE_Predictive_Node.cpp:245-261).

    Only the last non-zero decision at or before c matters (0 keeps the
    frequency), so find its index with a running max over the indices of
    the non-zero decisions; cycles before any such decision keep the
    initial frequency.
    """
    idx = torch.arange(decision.shape[0], device=decision.device)
    last = torch.where(decision != DECISION_ALL_BUSY, idx, -1).cummax(dim=0).values
    held = torch.where(last >= 0, decision[last.clamp(min=0)], DECISION_ALL_BUSY)
    return next_tx_channel(held, initial_tx_freq_hz, channels_hz)
