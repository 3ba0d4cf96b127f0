"""Canonical IQ representations (port of ``cognitive_radio_network_tpu/signal/iq.py``).

The framework's on-device IQ formats are **float32 real pairs**:

* **planar** (the hot path): a ``(xr, xi)`` tuple of separate I and Q
  tensors, each ``(..., N)``, contiguous, so the kernel reads each plane with
  coalesced loads and no de-interleave;
* **interleaved planes**: one tensor ``(..., N, 2)`` with the last axis
  ``[I, Q]``, the layout of SDR captures (:mod:`..io.iq`).

Complex tensors (and complex numpy arrays) are accepted at every public entry
point; :func:`split_iq` normalizes any form to an (I, Q) pair.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["split_iq", "to_planes", "to_planar", "from_planes"]


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def split_iq(x) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalize complex (..., N), planes (..., N, 2), or a planar
    ``(xr, xi)`` tuple to contiguous float32 (re, im), each (..., N).

    The real and imaginary parts of a complex tensor, and the columns of
    planes, are strided views; they are copied here, once, so the kernels
    downstream get the contiguous planes they take."""
    if isinstance(x, (tuple, list)):
        xr, xi = x
        xr, xi = _tensor(xr), _tensor(xi)
    else:
        x = _tensor(x)
        if x.is_complex():
            xr, xi = x.real, x.imag
        elif x.shape[-1] == 2:
            xr, xi = x[..., 0], x[..., 1]
        else:
            raise ValueError(
                f"IQ input must be complex, (..., 2) planes, or an (xr, xi) tuple; "
                f"got {x.dtype} {tuple(x.shape)}"
            )
    return xr.float().contiguous(), xi.float().contiguous()


def to_planar(x) -> tuple[torch.Tensor, torch.Tensor]:
    """Any IQ form -> planar (xr, xi) tuple (alias of split_iq)."""
    return split_iq(x)


def to_planes(x):
    """Complex array -> float32 planes (..., 2); numpy in, numpy out."""
    if isinstance(x, np.ndarray):
        return np.stack([x.real, x.imag], axis=-1).astype(np.float32)
    return torch.stack([x.real, x.imag], dim=-1).float()


def from_planes(x):
    """Planes (..., 2) -> complex64; numpy in, numpy out."""
    if isinstance(x, np.ndarray):
        return (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)
    return torch.complex(x[..., 0].float(), x[..., 1].float())
