"""Greedy resolution of frame candidates, in offset order, on the tensors' device.

The adaptive stream step (``phy/stream.py``) finds K candidates per block and
must decide which are frames: walking them in offset order it takes a candidate
that clears the threshold, starts at or after the end of the last frame taken,
has a valid header and lies whole inside the buffer, and it stops at the first
one whose header region or frame overruns the buffer (the rest of that frame
arrives with the next block, so the residual is kept from its start).

The JAX package runs this walk as a ``lax.scan`` inside its stream-step graph
(``cognitive_radio_network_tpu/phy/framesync.py``, ``_stream_step_graph``); no
TPU kernel stands behind it.  Here it is a CUDA C++ kernel,
``csrc/resolve_candidates.cu``, so that a stream step needs no device-to-host
copy and steps queue on the card one behind the other.

:func:`resolve_candidates` launches the kernel for CUDA tensors and runs
:func:`resolve_candidates_plain`, a Python loop over the same columns, for
CPU tensors.  The choice follows the tensor's device only; on a CUDA tensor
the wrapper launches the kernel or raises.  Both are exact (integers and one
float32 compare).
"""

from __future__ import annotations

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.ops._launch import input_ptr, launch
from cognitive_radio_network_tpu_torch.utils.device import on_cuda

__all__ = ["resolve_candidates", "resolve_candidates_plain"]


def resolve_candidates_plain(
    offs: torch.Tensor,
    peaks: torch.Tensor,
    ok: torch.Tensor,
    flen: torch.Tensor,
    keep0: torch.Tensor,
    thr: float,
    n: int,
    prefix: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the walk as a host loop.  Tensors on a card are fetched
    first (a device-to-host copy, which waits for the card) and the result goes
    back to their device."""
    dev = offs.device
    thr = float(np.float32(thr))  # the kernel compares in float32
    consumed, keep_from, stopped = 0, int(keep0), False
    accept = []
    for off, pk, good, fl in zip(offs.tolist(), peaks.tolist(), ok.tolist(), flen.tolist()):
        take = False
        if not stopped and pk >= thr and off >= consumed:
            if off + prefix > n:
                stopped = True  # header region incomplete
            elif good:
                if off + fl > n:
                    stopped = True  # frame incomplete
                else:
                    take = True
                    consumed = off + fl
            if stopped:
                keep_from = min(keep_from, off)
        accept.append(take)
    return (
        torch.tensor(accept, dtype=torch.bool).to(dev),
        torch.tensor([consumed, keep_from, int(stopped)], dtype=torch.int64).to(dev),
    )


def resolve_candidates(
    offs: torch.Tensor,
    peaks: torch.Tensor,
    ok: torch.Tensor,
    flen: torch.Tensor,
    keep0: torch.Tensor,
    thr: float,
    n: int,
    prefix: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidates sorted by offset -> (accept (K,) bool, meta (3,) int64).

    ``offs`` (K,) int64 frame starts; ``peaks`` (K,) float32 detection metric;
    ``ok`` (K,) bool: header CRC passed and the PHY header parses; ``flen`` (K,)
    int64 frame length from each candidate's own header; ``keep0`` int64 with
    one element: the residual's keep point when no frame is incomplete;
    ``thr`` the detection threshold; ``n`` the buffer's length; ``prefix`` the
    length of a frame's preamble and header region.  ``meta`` holds the end of
    the last accepted frame, the keep point, and 1 when the walk stopped at an
    incomplete frame.

    CPU tensors run :func:`resolve_candidates_plain`.  CUDA tensors launch the
    kernel on the current stream without synchronizing; each launch adds one
    to ``resolve_candidates.launches``."""
    if not on_cuda(offs):
        return resolve_candidates_plain(offs, peaks, ok, flen, keep0, thr, n, prefix)
    dev = offs.device
    want = (("offs", offs, torch.int64), ("peaks", peaks, torch.float32), ("ok", ok, torch.bool),
            ("flen", flen, torch.int64), ("keep0", keep0, torch.int64))
    for what, t, dtype in want:
        if t.dtype != dtype:
            raise TypeError(f"kernel takes {dtype} {what}, got {t.dtype}")
    k = offs.shape[0]
    if offs.ndim != 1 or any(t.shape != (k,) for t in (peaks, ok, flen)) or keep0.numel() != 1:
        raise ValueError(
            f"expected four (K,) columns and one keep0, got {tuple(offs.shape)}, "
            f"{tuple(peaks.shape)}, {tuple(ok.shape)}, {tuple(flen.shape)}, {tuple(keep0.shape)}"
        )
    ptrs = [input_ptr(t, what, dev) for what, t, _ in want]
    accept = torch.empty(k, dtype=torch.bool, device=dev)
    meta = torch.empty(3, dtype=torch.int64, device=dev)
    launch(
        "crn_resolve_candidates", dev,
        *ptrs, accept.data_ptr(), meta.data_ptr(), k, float(thr), int(n), int(prefix),
    )
    resolve_candidates.launches += 1
    return accept, meta


resolve_candidates.launches = 0
