"""Dynamic window extraction: K frame-aligned windows of two IQ planes.

Port of ``cognitive_radio_network_tpu/ops/extract.py`` (the Pallas TPU
kernel ``_extract_kernel``) to a CUDA C++ kernel for Hopper,
``csrc/extract_windows.cu``.  The OFDM receive path needs rows
``x[o_k : o_k + wlen]`` at K offsets found by detection: the matched-filter
windows of the timing refinement, the frame windows of the demodulator and
the header windows of the block scan.  The adaptive stream step asks for its
header windows and each speculated configuration's frame windows at the same
offsets, so one launch gathers up to four window sets at one offset vector.

Contract, per set of length ``wlen``: offsets are clipped to
``[0, max(N - wlen, 0)]`` (for that set alone: near the end of the planes a
prefix of a long window is not the short window); when N < wlen the planes
are zero-padded to wlen first.  The result is bit-exact: a copy.

:func:`extract_windows` (one set) and :func:`extract_window_sets` launch the
kernel for CUDA tensors and run :func:`extract_windows_plain` and
:func:`extract_window_sets_plain`, the same contract in plain PyTorch, for CPU
tensors.  The choice follows the tensor's device only; on a CUDA tensor the
wrapper launches the kernel or raises.  Every function takes ``out=``, a
(wr, wi) pair per set that the caller owns and reuses from call to call; it
must be contiguous (K, wlen) of the planes' dtype (float32 on a card) on their
device.  Without it one
allocation holds every set's windows (:func:`window_buffers`).
"""

from __future__ import annotations

import torch

from cognitive_radio_network_tpu_torch.ops._launch import input_ptr, launch
from cognitive_radio_network_tpu_torch.utils.device import on_cuda

__all__ = [
    "extract_window_sets",
    "extract_window_sets_plain",
    "extract_windows",
    "extract_windows_plain",
    "window_buffers",
]

MAX_SETS = 4  # window sets per launch
_MAX_WLEN = 2**31 - 1  # the kernel's int lengths
_ALIGN = 64  # floats between the sets of one allocation: each set starts 256-byte aligned

Pair = tuple[torch.Tensor, torch.Tensor]


def window_buffers(like: torch.Tensor, k: int, wlens) -> tuple[Pair, ...]:
    """One (wr, wi) pair of contiguous (k, wlen) tensors per length in
    ``wlens``, of ``like``'s dtype on its device, all views of ONE
    allocation, each set's planes 256-byte aligned within it (views by
    ``as_strided``, the cheapest to make: a wrapper without ``out=`` makes
    them on every call)."""
    sizes = [-(-k * w // _ALIGN) * _ALIGN for w in wlens]
    flat = like.new_empty(2 * sum(sizes))
    pairs, at = [], 0
    for w, size in zip(wlens, sizes):
        pairs.append((flat.as_strided((k, w), (w, 1), at),
                      flat.as_strided((k, w), (w, 1), at + size)))
        at += 2 * size
    return tuple(pairs)


def _refuse(x: torch.Tensor, k: int, wlen: int, like: torch.Tensor) -> None:
    """Raise for a caller's window ``x`` that is not contiguous (k, wlen) of
    the planes' dtype on their device."""
    if x.dtype != like.dtype:
        raise TypeError(f"out must be {like.dtype}, got {x.dtype}")
    if x.device != like.device:
        raise ValueError(f"planes on {like.device} but out on {x.device}")
    if x.shape != (k, wlen):
        raise ValueError(f"out must be ({k}, {wlen}), got {tuple(x.shape)}")
    raise ValueError("out must be contiguous")


def _outputs(rr: torch.Tensor, k: int, wlens: tuple[int, ...], out) -> tuple[Pair, ...]:
    """The windows to write: ``out`` after its checks (one (wr, wi) pair per
    length, each contiguous (k, wlen) of the planes' dtype on their device;
    one test per tensor, as this runs on every call), or one new allocation."""
    if out is None:
        return window_buffers(rr, k, wlens)
    if len(out) != len(wlens):
        raise ValueError(f"{len(wlens)} window lengths but {len(out)} output pairs")
    dtype, device = rr.dtype, rr.device
    for pair, wlen in zip(out, wlens):
        for x in pair:
            if (x.dtype != dtype or x.device != device or x.shape != (k, wlen)
                    or not x.is_contiguous()):
                _refuse(x, k, wlen, rr)
    return out


def _lengths(wlens) -> tuple[int, ...]:
    wlens = tuple(map(int, wlens))
    if not 1 <= len(wlens) <= MAX_SETS:
        raise ValueError(f"1 to {MAX_SETS} window lengths per launch, got {len(wlens)}")
    if min(wlens) < 0 or max(wlens) > _MAX_WLEN:
        raise ValueError(f"window lengths {wlens} outside [0, {_MAX_WLEN}]")
    return wlens


def extract_window_sets_plain(
    rr: torch.Tensor, ri: torch.Tensor, offsets: torch.Tensor, wlens, *, out=None
) -> tuple[Pair, ...]:
    """Plain PyTorch version: per set, clip, then gather rows of the
    ``unfold`` view into the set's output pair."""
    wlens = _lengths(wlens)
    n = rr.shape[0]
    outs = _outputs(rr, offsets.shape[0], wlens, out)
    for (wr, wi), wlen in zip(outs, wlens):
        if wlen == 0 or wr.shape[0] == 0:
            continue
        o = offsets.to(torch.int64).clamp(0, max(n - wlen, 0))
        a, b = rr, ri
        if n < wlen:
            a = torch.nn.functional.pad(rr, (0, wlen - n))
            b = torch.nn.functional.pad(ri, (0, wlen - n))
        torch.index_select(a.unfold(0, wlen, 1), 0, o, out=wr)
        torch.index_select(b.unfold(0, wlen, 1), 0, o, out=wi)
    return outs


def extract_windows_plain(
    rr: torch.Tensor, ri: torch.Tensor, offsets: torch.Tensor, wlen: int, *, out=None
) -> Pair:
    """Plain PyTorch version of :func:`extract_windows`."""
    return extract_window_sets_plain(rr, ri, offsets, (wlen,), out=None if out is None else (out,))[0]


def extract_window_sets(
    rr: torch.Tensor, ri: torch.Tensor, offsets: torch.Tensor, wlens, *, out=None
) -> tuple[Pair, ...]:
    """rr/ri (N,) float32 + offsets (K,) int + 1 to 4 window lengths -> one
    ((K, wlen), (K, wlen)) float32 pair per length, row k of set s =
    plane[o_k : o_k + wlen_s] with o_k clipped to [0, N - wlen_s].

    CPU tensors run :func:`extract_window_sets_plain`.  CUDA tensors launch the
    kernel ONCE for every set, on the current stream without synchronizing:
    the planes must be contiguous float32 on one card, the offsets int32 or
    int64 on the same card (the kernel reads either as it is).  ``out`` is a
    pair per set (see the module); without it one allocation holds them all.
    Each launch adds one to ``extract_windows.launches``."""
    if not on_cuda(rr):
        return extract_window_sets_plain(rr, ri, offsets, wlens, out=out)
    wlens = _lengths(wlens)
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
    if not offsets.is_contiguous():
        offsets = offsets.contiguous()
    p_rr = input_ptr(rr, "rr", dev)
    p_ri = input_ptr(ri, "ri", dev)
    p_offs = input_ptr(offsets, "offsets", dev)
    k = offsets.shape[0]
    outs = _outputs(rr, k, wlens, out)
    if k == 0 or not any(wlens):
        return outs
    sets = []
    for (wr, wi), w in zip(outs, wlens):
        sets += (wr.data_ptr(), wi.data_ptr(), w)
    sets += (None, None, 0) * (MAX_SETS - len(wlens))
    launch("crn_extract_window_sets", dev, p_rr, p_ri, p_offs, int(i32), rr.shape[0], k,
           len(wlens), *sets)
    extract_windows.launches += 1
    return outs


def extract_windows(
    rr: torch.Tensor, ri: torch.Tensor, offsets: torch.Tensor, wlen: int, *, out=None
) -> Pair:
    """rr/ri (N,) float32 + offsets (K,) int -> ((K, wlen), (K, wlen)) float32,
    row k = plane[o_k : o_k + wlen] with o_k clipped to [0, N - wlen]:
    :func:`extract_window_sets` with one set; ``out`` is one (wr, wi) pair.
    Each launch adds one to ``extract_windows.launches``."""
    return extract_window_sets(rr, ri, offsets, (wlen,), out=None if out is None else (out,))[0]


extract_windows.launches = 0
