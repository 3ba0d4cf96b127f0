"""The fused 64-channel wideband energy detector: wide streams -> per-cycle channel energy.

Port of ``cognitive_radio_network_tpu/ops/fused_wideband.py`` (the Pallas TPU
kernel ``_kernel``) to a CUDA C++ kernel for Hopper,
``csrc/fused_wideband.cu``.  Per sense cycle of ``block_len`` channel-rate
times it computes the 64-channel generalisation of the reference's joint
3-channel sensing (CE_Predictive_Node.cpp:146-197):

    8-tap polyphase FIR per channel -> 64-point DFT over the channel axis
    -> |y|^2 -> mean over the cycle's times

with the FIR, the DFT, the power and the mean in one kernel, so device memory
sees the input once and (C, 64) energies.

Two layouts, each with leading batch dimensions, one launch a call whatever
the batch:

- :func:`wideband_energy_fused` takes planar streams ``xr``, ``xi`` of shape
  ``(..., T*M)``;
- :func:`wideband_energy_fused_planes` takes interleaved planes
  ``(..., T*M, 2)`` (``[re, im]`` pairs; a complex64 tensor is that layout
  through ``torch.view_as_real``) and reads them in place;
- :func:`wideband_detect_fused` takes either and also returns each cycle's
  noise floor and the energy detector's decisions (:func:`detect_rule`),
  made in the same launch, and can write each stream's last 8 rows as the
  history of the stream's next part (``tail_out``).

Streams may lie at any one stride that is a whole number of rows (64
samples), so evenly spaced streams need no copy.  Each runs for CUDA tensors
and runs its plain PyTorch version (:func:`wideband_energy_fused_plain`,
:func:`wideband_energy_fused_planes_plain`: shifted multiply-adds, one
(T, 128) @ (128, 128) product, power, mean) for CPU tensors.  The choice
follows the tensor's device only; on a CUDA tensor the wrapper launches the
kernel or raises.

The kernel computes in float32 at every ``precision``; the argument selects
the matmul precision of the plain version only.  The reference's ``tile_q``
and ``interpret`` arguments, and its rule that T*M divide into
(2M x tile_q) tiles, belong to the TPU's tiling and have no counterpart.

The FIR's tap order lives here once, in :func:`_fir_rows`;
``parallel/wideband.py::wideband_energy_packed`` runs the same rows.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.ops._launch import launch
from cognitive_radio_network_tpu_torch.signal.channelizer import _dft_tables
from cognitive_radio_network_tpu_torch.signal.fft import PRECISIONS, _mm
from cognitive_radio_network_tpu_torch.utils.device import on_cuda

__all__ = [
    "detect_rule",
    "in_place_or_copy",
    "tail_rows",
    "wideband_detect_fused",
    "wideband_energy_fused",
    "wideband_energy_fused_plain",
    "wideband_energy_fused_planes",
    "wideband_energy_fused_planes_plain",
]

_M = 64  # channels of the kernel
_P = 8  # taps per channel of the kernel (delays 0..7)


@functools.lru_cache(maxsize=32)
def _dft_complex_block(m: int, device: torch.device) -> torch.Tensor:
    """(2M, 2M) real matrix of the length-M DFT of lane-concat complex rows:
    [yr | yi] = [vr | vi] @ [[Wre, Wim], [-Wim, Wre]]."""
    wre, wim = _dft_tables(m, device)
    return torch.cat([torch.cat([wre, wim], dim=1), torch.cat([-wim, wre], dim=1)], dim=0)


def _fir_rows(v_in: torch.Tensor, taps: torch.Tensor, history: torch.Tensor | None) -> torch.Tensor:
    """Depthwise polyphase FIR on lane-concat planes.

    v_in: (..., T, 2M) rows [xr_phases | xi_phases]; taps (P, M).  Returns
    (..., T, 2M) with v[t, c] = sum_d taps[d, c] * v_in[t - d, c] per plane:
    P shifted multiply-adds, from the oldest delay to the newest, no matmul.
    ``history`` (..., P-1, 2M) holds the rows before the first one
    (overlap-save carry; zeros when None)."""
    p = taps.shape[0]
    t = v_in.shape[-2]
    hf = torch.flip(taps.float(), dims=(0,))
    hf2 = torch.cat([hf, hf], dim=1)  # (P, 2M): the same taps for both planes
    if history is None:
        history = v_in.new_zeros((*v_in.shape[:-2], p - 1, v_in.shape[-1]))
    ext = torch.cat([history, v_in], dim=-2)  # (..., T + P - 1, 2M)
    v = hf2[0] * ext[..., 0:t, :]
    for s in range(1, p):
        v = v + hf2[s] * ext[..., s : s + t, :]
    return v


def _energy_rows(
    xr: torch.Tensor,
    xi: torch.Tensor,
    taps: torch.Tensor,
    block_len: int,
    history: torch.Tensor | None,
    precision: str,
) -> torch.Tensor:
    """xr/xi (..., T*M) planar streams -> (..., T/block_len, M) cycle energies:
    FIR rows, one complex-packed DFT matmul, power, mean over each cycle."""
    m = taps.shape[1]
    lead = xr.shape[:-1]
    t_total = xr.shape[-1] // m
    v_in = torch.cat([xr.reshape(*lead, t_total, m), xi.reshape(*lead, t_total, m)], dim=-1)
    v = _fir_rows(v_in.float(), taps, history)
    y = _mm(v, _dft_complex_block(m, v.device), precision)
    power = y[..., :m] ** 2 + y[..., m:] ** 2
    return power.reshape(*lead, t_total // block_len, block_len, m).mean(dim=-2)


def detect_rule(energy: torch.Tensor, ratio: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., C, M) cycle energies -> each cycle's noise floor (..., C, 1), a
    sort-free estimate from the channels' mean and minimum, and the energy
    detector's decisions (..., C, M): energy above ``ratio`` times the floor.
    The kernel makes the same decisions from its own floor."""
    mean_e = energy.mean(dim=-1, keepdim=True)
    min_e = energy.amin(dim=-1, keepdim=True)
    noise = 0.5 * (min_e + torch.minimum(mean_e, 2.0 * min_e))
    return noise, energy > ratio * noise


def tail_rows(streams, m: int, rows: int) -> torch.Tensor:
    """The last ``rows`` wide rows of each stream as (..., 2, rows, M) float32
    (plane, row, channel), from planar ``(xr, xi)`` streams (..., T*M) (a
    copy) or interleaved planes (..., T*M, 2) (a view).  With ``rows`` 8, each
    plane made contiguous is the kernel's history form: its 4 pair rows."""
    if isinstance(streams, tuple):
        n = streams[0].shape[-1]
        return torch.stack([v[..., n - rows * m :].reshape(*v.shape[:-1], rows, m) for v in streams],
                           dim=-3)
    n = streams.shape[-2]
    return streams[..., n - rows * m :, :].reshape(*streams.shape[:-2], rows, m, 2).movedim(-1, -3)


def _stream_stride(x: torch.Tensor, n_lead: int, row: int, what: str) -> int:
    """The stride in floats between the streams of ``x`` (its first ``n_lead``
    dimensions), 0 for one stream.  Raises ValueError unless the streams lie
    at one stride that is a whole number of ``row``-float rows."""
    got = _stride_of(x.shape, x.stride(), n_lead, row)
    if isinstance(got, str):
        raise ValueError(got.format(what=what))
    return got


@functools.lru_cache(maxsize=256)
def _stride_of(shape, strides, n_lead: int, row: int):
    """:func:`_stream_stride` of a layout, or its error's message (a launch's
    layouts repeat from call to call, so each is worked out once)."""
    dims = [(n, st) for n, st in zip(shape[:n_lead], strides[:n_lead]) if n != 1]
    if not dims:
        return 0
    for (_, outer), (n, inner) in zip(dims, dims[1:]):
        if outer != inner * n:
            return f"the streams of {{what}} must lie at one stride, got strides {strides}"
    stride = dims[-1][1]
    if stride % row:
        return f"a stream stride of {stride} floats in {{what}} is not a whole number of rows of {row}"
    return stride


def _inner_contiguous(x: torch.Tensor, n_lead: int) -> bool:
    """Whether each stream of ``x`` (its dimensions after the first
    ``n_lead``) lies contiguous in memory."""
    return _contiguous_of(x.shape, x.stride(), n_lead)


@functools.lru_cache(maxsize=256)
def _contiguous_of(shape, strides, n_lead: int) -> bool:
    want = 1
    for n, st in zip(reversed(shape[n_lead:]), reversed(strides[n_lead:])):
        if n != 1 and st != want:
            return False
        want *= n
    return True


def _check(streams, taps, cfg, initial_history, *, planes: bool, tail_out=None):
    """The contract of the kernel and of its plain versions: ``streams`` is
    ``(xr, xi)``, each (..., T*M), or with ``planes`` one (..., T*M, 2)
    tensor; ``initial_history`` and ``tail_out`` are pair rows (..., 4, 2M).
    Returns (leading dimensions, T, the streams' strides)."""
    m, p = cfg.num_channels, cfg.taps_per_channel
    if (m, p) != (_M, _P):
        raise ValueError(f"fused path requires M=64, P=8, got {(m, p)}")
    if cfg.block_len < 2 or cfg.block_len % 2:
        raise ValueError(f"block_len must be even, got {cfg.block_len}")
    if tuple(taps.shape) != (_P, _M):
        raise ValueError(f"taps must be ({_P}, {_M}), got {tuple(taps.shape)}")
    if planes:
        x = streams
        if x.dim() < 2 or x.shape[-1] != 2:
            raise ValueError(f"expected interleaved planes (..., T*M, 2), got {tuple(x.shape)}")
        lead, n_wide = x.shape[:-2], x.shape[-2]
        strides = (_stream_stride(x, len(lead), 2 * m, "planes"),)
    else:
        xr, xi = streams
        if xr.dim() < 1 or xr.shape != xi.shape:
            raise ValueError(
                f"expected planar streams (..., T*M), got {tuple(xr.shape)} and {tuple(xi.shape)}"
            )
        lead, n_wide = xr.shape[:-1], xr.shape[-1]
        strides = tuple(_stream_stride(x, len(lead), m, w) for x, w in ((xr, "xr"), (xi, "xi")))
    if n_wide % m or (n_wide // m) % cfg.block_len:
        raise ValueError(
            f"T*M = {n_wide} must hold whole sense cycles of {cfg.block_len} x {m} samples"
        )
    for what, pair in (("initial_history", initial_history), ("tail_out", tail_out)):
        for hist in pair or ():
            if tuple(hist.shape) != (*lead, 4, 2 * m):
                raise ValueError(
                    f"{what} rows must be (4, {2 * m}) after the streams' leading "
                    f"dimensions {tuple(lead)}, got {tuple(hist.shape)}"
                )
    return tuple(lead), n_wide // m, strides


def _plain(xr, xi, taps, cfg, precision, initial_history) -> torch.Tensor:
    history = None
    if initial_history is not None:
        # (..., 4, 2M) pair rows -> the 8 phase rows before the stream, of
        # which the FIR needs the last 7: (..., 7, 2M) as _fir_rows takes it
        hist_r, hist_i = (h.float().reshape(*h.shape[:-2], _P, _M)[..., 1:, :] for h in initial_history)
        history = torch.cat([hist_r, hist_i], dim=-1)
    return _energy_rows(xr, xi, taps, cfg.block_len, history, precision)


def wideband_energy_fused_plain(
    xr: torch.Tensor,
    xi: torch.Tensor,
    taps,
    cfg,
    *,
    precision: str = "high",
    initial_history: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel on planar streams: (..., C, 64)
    float32 cycle energies.

    ``initial_history`` is in the reference's pair rows, (..., 4, 128) per
    plane: row q holds the wide sample times 2q and 2q+1, so it reshapes to
    the 8 phase rows before the stream, of which the FIR needs the last 7."""
    taps = torch.as_tensor(taps, dtype=torch.float32, device=xr.device)
    _check((xr, xi), taps, cfg, initial_history, planes=False)
    return _plain(xr, xi, taps, cfg, precision, initial_history)


def wideband_energy_fused_planes_plain(
    planes: torch.Tensor,
    taps,
    cfg,
    *,
    precision: str = "high",
    initial_history: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel on interleaved planes (..., T*M, 2)
    (complex input through ``torch.view_as_real``): (..., C, 64) float32
    cycle energies, bit-equal to :func:`wideband_energy_fused_plain` on the
    two planes."""
    planes = _as_planes(planes)
    taps = torch.as_tensor(taps, dtype=torch.float32, device=planes.device)
    _check(planes, taps, cfg, initial_history, planes=True)
    return _plain(planes[..., 0], planes[..., 1], taps, cfg, precision, initial_history)


def _as_planes(planes: torch.Tensor) -> torch.Tensor:
    """Complex streams as their (..., N, 2) real view; planes as they are."""
    return torch.view_as_real(planes) if planes.is_complex() else planes


def in_place_or_copy(x: torch.Tensor, *, planes: bool) -> torch.Tensor:
    """``x`` (float32 planar streams (..., N), or with ``planes`` interleaved
    (..., N, 2)) as the kernel reads it: itself when it can be read in place
    (each stream contiguous, the streams at one stride of whole rows, a
    16-byte aligned base), else a contiguous copy."""
    n_lead = x.dim() - (2 if planes else 1)
    try:
        ok = _inner_contiguous(x, n_lead) and x.data_ptr() % 16 == 0
        ok = ok and _stream_stride(x, n_lead, 2 * _M if planes else _M, "x") % 4 == 0
    except ValueError:
        ok = False
    return x if ok else x.clone(memory_format=torch.contiguous_format)


@functools.lru_cache(maxsize=8)
def _twiddles(device: torch.device) -> torch.Tensor:
    """(2, 32) float32 cos/sin of -2*pi*k/64, built in float64."""
    ang = -2.0 * np.pi * np.arange(_M // 2) / _M
    return torch.from_numpy(np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)).to(device)


def _kernel_input(x: torch.Tensor, what: str, device: torch.device, n_lead: int) -> int:
    """The address of float32 kernel input ``x`` after its checks: on
    ``device``, each stream contiguous, a 16-byte aligned base."""
    if x.dtype != torch.float32:
        raise TypeError(f"kernel takes float32 {what}, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"kernel input on {device} but {what} on {x.device}: one card")
    if not _inner_contiguous(x, n_lead):
        raise ValueError(f"kernel takes {what} with each stream contiguous")
    ptr = x.data_ptr()
    if ptr % 16:
        raise ValueError(f"kernel takes 16-byte aligned {what}")
    return ptr


def _launch(streams, taps, cfg, initial_history, *, planes: bool, ratio=None, tail_out=None):
    """One launch over every stream of ``streams`` (checked by :func:`_check`):
    the energies, or with ``ratio`` (energy, noise, occupied); with
    ``tail_out`` each stream's last 8 rows written there too."""
    first = streams if planes else streams[0]
    dev = first.device
    taps = torch.as_tensor(taps, dtype=torch.float32, device=dev)
    lead, t_total, strides = _check(streams, taps, cfg, initial_history, planes=planes,
                                    tail_out=tail_out)
    n_lead = len(lead)
    if planes:
        p_r, p_i = _kernel_input(streams, "planes", dev, n_lead), None
        s_r, s_i = strides[0], 0
    else:
        p_r = _kernel_input(streams[0], "xr", dev, n_lead)
        p_i = _kernel_input(streams[1], "xi", dev, n_lead)
        s_r, s_i = strides
    h_r = h_i = None
    hs_r = hs_i = 0
    if initial_history is not None:
        # any stride of whole 16-byte vectors: a stream's history is 512 floats
        h_r, h_i = (_kernel_input(h, "initial_history", dev, n_lead) for h in initial_history)
        hs_r, hs_i = (_stream_stride(h, n_lead, 4, "initial_history") for h in initial_history)
    t_r = t_i = None
    ts_r = ts_i = 0
    if tail_out is not None:
        t_r, t_i = (_kernel_input(h, "tail_out", dev, n_lead) for h in tail_out)
        ts_r, ts_i = (_stream_stride(h, n_lead, 4, "tail_out") for h in tail_out)
    taps = taps.contiguous()
    c = t_total // cfg.block_len
    batch = math.prod(lead)
    out = first.new_empty((*lead, c, _M), dtype=torch.float32)
    noise = occ = None
    if ratio is not None:
        noise = first.new_empty((*lead, c, 1), dtype=torch.float32)
        occ = first.new_empty((*lead, c, _M), dtype=torch.bool)
    if c and batch:
        launch(
            "crn_fused_wideband", dev,
            p_r, p_i, s_r, s_i, h_r, h_i, hs_r, hs_i, taps.data_ptr(), _twiddles(dev).data_ptr(),
            out.data_ptr(), None if noise is None else noise.data_ptr(),
            None if occ is None else occ.data_ptr(), 0.0 if ratio is None else float(ratio),
            t_r, t_i, ts_r, ts_i, batch, c, cfg.block_len, int(planes),
        )
        wideband_energy_fused.launches += 1
    return out if ratio is None else (out, noise, occ)


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of {PRECISIONS}")


def wideband_energy_fused(
    xr: torch.Tensor,
    xi: torch.Tensor,
    taps,
    cfg,
    *,
    precision: str = "high",
    initial_history: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """xr/xi: (..., T*M) float32 planar wide streams -> (..., C, M) per-cycle
    channel energies, C = T / cfg.block_len; each stream of the leading
    dimensions is a stream of its own.  Numerically matches
    ``parallel/wideband.py::wideband_energy_packed`` (same taps, same DFT).

    Requires M=64, P=8, an even ``block_len`` and T a multiple of it, and the
    streams at one stride that is a whole number of rows of 64.
    ``initial_history``: optional (hist_r, hist_i), each (..., 4, 2M)
    float32, the 4 pair rows (8 wide sample times) right before each stream,
    which seed the FIR instead of rest-from-zero (the carry between two parts
    of one stream).

    CPU tensors run :func:`wideband_energy_fused_plain`.  CUDA tensors make
    one launch for the whole batch on the current stream, without
    synchronizing; each stream must be contiguous and the bases 16-byte
    aligned float32 on one card.  Each launch adds one to
    ``wideband_energy_fused.launches``.
    """
    _check_precision(precision)
    if not on_cuda(xr):
        return wideband_energy_fused_plain(
            xr, xi, taps, cfg, precision=precision, initial_history=initial_history
        )
    return _launch((xr, xi), taps, cfg, initial_history, planes=False)


def wideband_energy_fused_planes(
    planes: torch.Tensor,
    taps,
    cfg,
    *,
    precision: str = "high",
    initial_history: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """:func:`wideband_energy_fused` on interleaved planes (..., T*M, 2)
    float32, or complex64 (..., T*M), read in place: the same bits as the
    planar form on the same samples.  The streams lie at one stride of whole
    rows of 64 pairs; each must be contiguous.  One launch a call, counted on
    ``wideband_energy_fused.launches``; CPU tensors run
    :func:`wideband_energy_fused_planes_plain`."""
    _check_precision(precision)
    planes = _as_planes(planes)
    if not on_cuda(planes):
        return wideband_energy_fused_planes_plain(
            planes, taps, cfg, precision=precision, initial_history=initial_history
        )
    return _launch(planes, taps, cfg, initial_history, planes=True)


def wideband_detect_fused(
    streams,
    taps,
    cfg,
    *,
    precision: str = "high",
    initial_history: tuple[torch.Tensor, torch.Tensor] | None = None,
    tail_out: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> dict:
    """Kernel 3 with the energy detector: planar ``(xr, xi)`` streams as
    :func:`wideband_energy_fused` takes them, or interleaved planes as
    :func:`wideband_energy_fused_planes` takes them, -> ``energy`` (..., C, M),
    ``noise`` (..., C, 1) and ``occupied`` (..., C, M) by :func:`detect_rule`
    with ``cfg.threshold_ratio``, all from one launch.

    ``tail_out`` (tail_r, tail_i), each (..., 4, 2M) float32 like
    ``initial_history`` and apart from it, receives each stream's last 8
    rows, which are the history of the stream's next part.  The kernel's
    noise floor sums the channels in another order than ``torch.mean``, so
    it may differ from :func:`detect_rule` on the same energies by a
    rounding; its decisions follow its own floor.  CPU tensors run the plain
    versions and :func:`detect_rule`; a launch is counted as the energy
    wrappers count theirs."""
    _check_precision(precision)
    planes = not isinstance(streams, tuple)
    if planes:
        streams = _as_planes(streams)
    first = streams if planes else streams[0]
    ratio = cfg.threshold_ratio
    if on_cuda(first):
        energy, noise, occ = _launch(streams, taps, cfg, initial_history, planes=planes,
                                     ratio=ratio, tail_out=tail_out)
        return {"energy": energy, "noise": noise, "occupied": occ}
    taps = torch.as_tensor(taps, dtype=torch.float32, device=first.device)
    _check(streams, taps, cfg, initial_history, planes=planes, tail_out=tail_out)
    xr, xi = (streams[..., 0], streams[..., 1]) if planes else streams
    energy = _plain(xr, xi, taps, cfg, precision, initial_history)
    if tail_out is not None:
        rows = tail_rows(streams, _M, min(_P, xr.shape[-1] // _M))
        if rows.shape[-2] < _P:  # a stream shorter than 8 rows: the history's rows before it
            hist = (torch.zeros_like(tail_out[0]), torch.zeros_like(tail_out[1])) \
                if initial_history is None else initial_history
            before = torch.stack([h.reshape(*h.shape[:-2], _P, _M) for h in hist], dim=-3)
            rows = torch.cat([before, rows], dim=-2)[..., rows.shape[-2]:, :]
        for plane, out in enumerate(tail_out):
            out.copy_(rows[..., plane, :, :].reshape(out.shape))
    noise, occ = detect_rule(energy, ratio)
    return {"energy": energy, "noise": noise, "occupied": occ}


wideband_energy_fused.launches = 0
