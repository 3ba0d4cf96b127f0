"""Dynamic window extraction: K frame-aligned windows of two IQ planes.

Port of ``cognitive_radio_network_tpu/ops/extract.py`` (the Pallas TPU
kernel ``_extract_kernel``) to a CUDA C++ kernel for Hopper,
``csrc/extract_windows.cu``.  The OFDM receive path needs rows
``x[o_k : o_k + wlen]`` at K offsets found by detection: the matched-filter
windows of the timing refinement, the frame windows of the demodulator and
the header windows of the block scan.

Contract: offsets are clipped to ``[0, max(N - wlen, 0)]``; when N < wlen the
planes are zero-padded to wlen first.  The result is bit-exact: a copy.

:func:`extract_windows` launches the kernel for CUDA tensors and runs
:func:`extract_windows_plain`, the same contract in plain PyTorch, for CPU
tensors.  The choice follows the tensor's device only; on a CUDA tensor the
wrapper launches the kernel or raises.
"""

from __future__ import annotations

import torch

from cognitive_radio_network_tpu_torch.ops._launch import input_ptr, launch
from cognitive_radio_network_tpu_torch.utils.device import on_cuda

__all__ = ["extract_windows", "extract_windows_plain"]

_MAX_WLEN = 65535 * 1024  # the kernel's grid.y limit times its chunk


def _clip(offsets: torch.Tensor, n: int, wlen: int) -> torch.Tensor:
    return offsets.to(torch.int64).clamp(0, max(n - wlen, 0))


def extract_windows_plain(
    rr: torch.Tensor, ri: torch.Tensor, offsets: torch.Tensor, wlen: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: clip, then gather rows of the ``unfold`` view."""
    n = rr.shape[0]
    o = _clip(offsets, n, wlen)
    if n < wlen:
        rr = torch.nn.functional.pad(rr, (0, wlen - n))
        ri = torch.nn.functional.pad(ri, (0, wlen - n))
    return rr.unfold(0, wlen, 1)[o], ri.unfold(0, wlen, 1)[o]


def extract_windows(
    rr: torch.Tensor, ri: torch.Tensor, offsets: torch.Tensor, wlen: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """rr/ri (N,) float32 + offsets (K,) int -> ((K, wlen), (K, wlen)) float32,
    row k = plane[o_k : o_k + wlen] with o_k clipped to [0, N - wlen].

    CPU tensors run :func:`extract_windows_plain`.  CUDA tensors launch the
    kernel on the current stream without synchronizing: the planes must be
    contiguous float32 on one card, the offsets int32 or int64 on the same
    card (the kernel reads either as it is).  Each launch adds one to
    ``extract_windows.launches``."""
    wlen = int(wlen)
    if not on_cuda(rr):
        return extract_windows_plain(rr, ri, offsets, wlen)
    dev = rr.device
    if rr.dtype != torch.float32 or ri.dtype != torch.float32:
        raise TypeError(f"kernel takes float32 planes, got {rr.dtype}, {ri.dtype}")
    i32 = offsets.dtype == torch.int32
    if not i32 and offsets.dtype != torch.int64:
        raise TypeError(f"offsets must be int32 or int64 integers, got {offsets.dtype}")
    if rr.ndim != 1 or ri.ndim != 1 or offsets.ndim != 1 or rr.shape[0] != ri.shape[0]:
        raise ValueError(
            f"expected planes (N,) and offsets (K,), got {tuple(rr.shape)}, "
            f"{tuple(ri.shape)}, {tuple(offsets.shape)}"
        )
    if not 0 <= wlen <= _MAX_WLEN:
        raise ValueError(f"wlen {wlen} outside [0, {_MAX_WLEN}]")
    if not offsets.is_contiguous():
        offsets = offsets.contiguous()
    p_rr = input_ptr(rr, "rr", dev)
    p_ri = input_ptr(ri, "ri", dev)
    p_offs = input_ptr(offsets, "offsets", dev)
    k = offsets.shape[0]
    out_r = rr.new_empty((k, wlen))
    out_i = rr.new_empty((k, wlen))
    if k == 0 or wlen == 0:
        return out_r, out_i
    launch(
        "crn_extract_windows", dev,
        p_rr, p_ri, p_offs, int(i32), out_r.data_ptr(), out_i.data_ptr(), rr.shape[0], k, wlen,
    )
    extract_windows.launches += 1
    return out_r, out_i


extract_windows.launches = 0
