"""Kernel-or-plain selection by the tensor's device, and f32 precision.

Replaces ``cognitive_radio_network_tpu/utils/platform.py``.  The reference
once chose its Pallas kernel by the process's default backend, so a
computation placed on the CPU still launched the TPU kernel and failed
(the round-4 finding recorded in that module).  Here the choice is made from
the tensor actually passed in: ``tensor.device.type``, never from what the
process has (``torch.cuda.is_available()``).
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["on_cuda", "full_f32", "require_device"]


def on_cuda(t: torch.Tensor) -> bool:
    """True when ``t`` lies on a CUDA device (kernel path), else plain path."""
    return t.device.type == "cuda"


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``, after proving that it exists: an
    empty tensor is made there, so a ``"cuda"`` device raises on a machine
    with no card instead of letting a caller carry on elsewhere."""
    device = torch.device(device)
    try:
        torch.empty(0, device=device)
    except (AssertionError, RuntimeError) as e:  # torch's "not compiled with CUDA" is an assert
        raise RuntimeError(f"device {device} is not available here: {e}") from e
    return device


@contextlib.contextmanager
def full_f32():
    """Run float32 matmuls and cuDNN convolutions in full float32.

    On the card a float32 convolution goes through cuDNN in TF32 by default,
    and a matmul does so whenever a caller enabled it; TF32 keeps about
    three decimal digits, which misses the reference's tolerances.  Both
    flags are set off for the block and restored after it.
    """
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
