"""Bit/byte packing helpers (MSB-first): host numpy and tensor forms.

Port of ``cognitive_radio_network_tpu/phy/bits.py``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["unpack_bits", "pack_bits", "unpack_bits_tensor", "pack_bits_tensor"]


def unpack_bits(data: np.ndarray) -> np.ndarray:
    """uint8 bytes (...,) -> bits (..., 8*n) MSB-first."""
    return np.unpackbits(np.asarray(data, np.uint8), axis=-1)


def pack_bits(bits: np.ndarray) -> np.ndarray:
    return np.packbits(np.asarray(bits, np.uint8), axis=-1)


def unpack_bits_tensor(data: torch.Tensor) -> torch.Tensor:
    """uint8 bytes (..., n) -> uint8 bits (..., 8*n), MSB-first."""
    data = data.to(torch.uint8)
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=data.device)
    bits = (data[..., None] >> shifts) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8)


def pack_bits_tensor(bits: torch.Tensor) -> torch.Tensor:
    """Bits (..., 8*n) -> uint8 bytes (..., n), MSB-first; a ragged tail is dropped."""
    n = bits.shape[-1] // 8
    b = bits[..., : n * 8].reshape(*bits.shape[:-1], n, 8).to(torch.int32)
    weights = 1 << torch.arange(7, -1, -1, dtype=torch.int32, device=bits.device)
    return (b * weights).sum(dim=-1).to(torch.uint8)
