"""The launch path the kernel wrappers share: input checks, then one ctypes call.

A wrapper's host time is what a small dispatch costs: the extract kernel
needs less time on the card than a few PyTorch calls need on the host
(PERF.md has the table).  So this path does each thing once: the entry point
and its ``argtypes`` are resolved at the first launch, the stream handle
comes from PyTorch's raw-stream call (no Stream object is built), the device
guard is entered only for a tensor that lies on another card than the current
one, and a check reads an attribute, it builds no tuple.

Nothing here runs at import: the CPU-only test machines have no ``nvcc``.
"""

from __future__ import annotations

import functools

import torch

from cognitive_radio_network_tpu_torch.ops import _build

__all__ = ["input_ptr", "launch"]


def input_ptr(x: torch.Tensor, what: str, device: torch.device, *, aligned: bool = False) -> int:
    """The address of kernel input ``x`` after the checks every kernel makes:
    on ``device`` (the first input's), contiguous and, with ``aligned`` (for a
    kernel that loads 16-byte vectors), 16-byte aligned.  Raises ValueError
    otherwise."""
    if x.device != device:
        raise ValueError(f"kernel input on {device} but {what} on {x.device}: one card")
    if not x.is_contiguous():
        raise ValueError(f"kernel takes contiguous {what}")
    ptr = x.data_ptr()
    if aligned and ptr % 16:
        raise ValueError(f"kernel takes 16-byte aligned {what}")
    return ptr


@functools.cache
def _entry(name: str):
    return getattr(_build.load(), name)


def launch(name: str, device: torch.device, *args) -> None:
    """Call entry point ``name`` of the kernel library with ``args`` and the
    current stream of ``device``, without synchronizing.  Raises RuntimeError
    with the CUDA error code when the launch is refused."""
    fn = _entry(name)
    # the device query without current_device()'s lazy-init check: the
    # wrappers launch only for CUDA tensors, so CUDA is initialized
    current = torch._C._cuda_getDevice()
    index = current if device.index is None else device.index
    if index == current:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
