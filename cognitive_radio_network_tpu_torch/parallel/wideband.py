"""Wideband sense pipeline: 64-channel channelizer -> energy detect, on one
device or sharded over a mesh.

Port of ``cognitive_radio_network_tpu/parallel/wideband.py`` (BASELINE.json
config 5).  The pipeline:

    wide IQ planes (T*M, 2), or a planar (xr, xi) tuple of (T*M,) streams
      -> polyphase FIR + M-point DFT + per-cycle per-channel energy
         [ops.fused_wideband: one CUDA kernel on the card]
      -> noise-floor estimate across channels
      -> per-channel occupancy decisions (energy detector); the energies and
         the floor also feed the shared-weight per-channel MLP
         (models/distributed.py)

On one device (``mesh=None``), which energy path runs follows the input: a
stream whose shape the fused path takes goes through
``wideband_energy_fused`` (the kernel for a CUDA tensor, its plain version
for a CPU tensor), a batch of such streams one call per stream; another
shape, or ``use_fused=False``, goes through :func:`wideband_energy_packed`.
(The reference keeps its kernel to the unbatched stream and sends a batch
through its packed XLA form; here a batch on the card runs the kernel too.)

Over a ``('time', 'channel'[, 'data'])`` mesh (:mod:`.mesh`), every rank is
given the whole input and takes its block of it: its segment of each stream
along ``time`` and, with ``batch_axis``, its rows of a batch.  The only
cross-shard traffic is the FIR state: the left neighbour's last phase rows
(P-1 for the packed form, 4 pair rows = 8 phase rows for the kernel, which
reads them as ``initial_history``) by one ring shift; shard 0 starts from
rest.  Along ``channel`` every rank of a channel group holds the same time
segment, as the reference's ``in_specs`` leave ``channel`` replicated: each
rank computes the energies and the noise floor over all M channels and keeps
its M/dc columns of ``energy`` and ``occupied`` (the reference's
``P(t, "channel")`` constraint), so no all-to-all is needed.  A batched
sharded block runs the kernel once per stream of the rank, each with its own
history (the one-device divergence above).

The reference's ``_pick_tile_q`` is the TPU kernel's tiling; the kernel here
has no ``tile_q``.  What is left of it is its per-shard constraint, raised as
an error by the fused path: each shard's T a multiple of ``block_len``
(even).  Its materializing-channelizer fallback, for shards that do not hold
whole sense cycles, has no counterpart: such a shape raises ValueError
(:func:`.halo.sharded_channelize` gives the channelized planes themselves).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from cognitive_radio_network_tpu_torch.ops.fused_wideband import (
    _energy_rows,
    wideband_energy_fused,
)
from cognitive_radio_network_tpu_torch.parallel.halo import left_tail
from cognitive_radio_network_tpu_torch.parallel.mesh import block, block_range
from cognitive_radio_network_tpu_torch.signal.channelizer import polyphase_taps
from cognitive_radio_network_tpu_torch.signal.iq import split_iq

__all__ = [
    "WidebandConfig",
    "wideband_sense",
    "wideband_energy_packed",
    "sharded_wideband_energy_packed",
    "sharded_wideband_energy_fused",
    "make_wideband_fn",
]


@dataclasses.dataclass(frozen=True)
class WidebandConfig:
    num_channels: int = 64
    taps_per_channel: int = 8
    block_len: int = 128  # per-channel samples per sense cycle
    threshold_ratio: float = 4.0  # occupancy if energy > ratio * noise floor
    # matmul precision of the plain paths.  The reference's three rungs are
    # two code paths here: "highest" and "high" are both float32 with TF32
    # off, "default" is one bf16 pass.  The kernel computes in float32 at
    # every rung.
    precision: str = "high"

    def taps(self) -> np.ndarray:
        return polyphase_taps(self.num_channels, self.taps_per_channel)


def wideband_energy_packed(
    xr: torch.Tensor,
    xi: torch.Tensor,
    taps,
    cfg: WidebandConfig,
    *,
    precision: str = "high",
) -> torch.Tensor:
    """Planar wide stream -> per-cycle channel energy, in plain PyTorch.

    Factored polyphase formulation: the FIR is P shifted multiply-adds on
    (T, 2M) rows [vr | vi] (depthwise: the dense (P*M, M) matrix of
    signal/channelizer.py multiplies the window again for every output), and
    the M-point DFT is one (T, 2M) @ (2M, 2M) complex-packed product.
    Energy only: the channelized IQ is never materialized.

    xr/xi: (T*M,) float32, or (..., T*M) with leading batch dimensions, each
    row a stream of its own whose FIR starts from rest.  Returns (C, M) or
    (..., C, M) with C = T / block_len.
    """
    m = cfg.num_channels
    taps = torch.as_tensor(taps, dtype=torch.float32, device=xr.device)
    t_total = xr.shape[-1] // m
    if xr.shape[-1] % m or t_total % cfg.block_len:
        raise ValueError(f"T={t_total} must be a multiple of block_len")
    return _energy_rows(xr, xi, taps, cfg.block_len, None, precision)


def _use_fused(cfg: WidebandConfig, t_total: int, use_fused: bool | None) -> bool:
    """Whether the fused path runs on a stream (or shard) of T=``t_total``:
    whenever its constraints hold (M=64, P=8, even block_len and T) unless
    the caller says; raises when asked for it on another shape."""
    fused_ok = (
        cfg.num_channels == 64
        and cfg.taps_per_channel == 8
        and cfg.block_len % 2 == 0
        and t_total % 2 == 0
    )
    if use_fused is None:
        return fused_ok
    if use_fused and not fused_ok:
        raise ValueError("fused path needs M=64, P=8, even block_len and an even T")
    return use_fused


def wideband_sense(
    planes,
    taps,
    cfg: WidebandConfig,
    *,
    mesh: DeviceMesh | None = None,
    batch_axis: str | None = None,
    use_fused: bool | None = None,
):
    """planes: (T*M, 2) / (B, T*M, 2) wide IQ at rate M * per-channel rate,
    or a planar tuple (xr, xi) of (T*M,) streams (the layout the kernel
    reads, so the card path makes no copy).

    Returns dict:
      energy   (..., C, M)  per-cycle per-channel mean power
      noise    (..., C, 1)  cross-channel noise-floor estimate
      occupied (..., C, M)  boolean energy-detector decisions
    with C = T / block_len sense cycles.

    The energy never needs the channelized IQ.  A stream goes through
    :func:`..ops.fused_wideband.wideband_energy_fused` when its shape allows
    (``use_fused=None`` selects it whenever M=64, P=8, block_len and T are
    even; the wrapper launches the kernel on a CUDA tensor), and a batch of
    streams goes through it stream by stream, each from rest: B launches.
    ``use_fused=True`` on another shape raises; ``use_fused=False`` takes
    :func:`wideband_energy_packed`.

    With ``mesh``, ``planes`` is the whole input on every rank (host or any
    device); this rank moves its block to ``taps``' device and returns its
    block of each output: cycles of its time segment, rows of its
    ``batch_axis`` block, columns of its ``channel`` block (the module
    docstring).  T must then split into whole cycles per time shard; the
    fused choice is made on the shard's T.
    """
    if mesh is not None:
        out = _sharded_sense(planes, taps, cfg, mesh, batch_axis, use_fused)
        lo, hi = block_range(cfg.num_channels, mesh, "channel")
        for key in ("energy", "occupied"):
            out[key] = out[key][..., lo:hi]
        return out
    m = cfg.num_channels
    if isinstance(planes, (tuple, list)):
        xr, xi = planes
    else:
        xr, xi = split_iq(planes)  # one copy per plane: the kernel reads contiguous planes
    t_total = xr.shape[-1] // m
    if xr.shape[-1] % m or t_total % cfg.block_len:
        raise ValueError(
            f"{xr.shape[-1]} wide samples do not divide into sense cycles of "
            f"{cfg.block_len} x {m}"
        )
    if not _use_fused(cfg, t_total, use_fused):
        energy = wideband_energy_packed(xr, xi, taps, cfg, precision=cfg.precision)
    elif xr.dim() == 1:
        energy = wideband_energy_fused(xr, xi, taps, cfg, precision=cfg.precision)
    else:
        lead, n_wide = xr.shape[:-1], xr.shape[-1]
        rows = [
            wideband_energy_fused(r, i, taps, cfg, precision=cfg.precision)
            for r, i in zip(xr.reshape(-1, n_wide), xi.reshape(-1, n_wide))
        ]
        cycles = t_total // cfg.block_len
        energy = torch.stack(rows) if rows else xr.new_zeros((0, cycles, m))
        energy = energy.reshape(*lead, cycles, m)
    return _decide(energy, cfg)


def _decide(energy: torch.Tensor, cfg: WidebandConfig) -> dict:
    """Noise floor (a sort-free estimate from the channels' mean and
    minimum) and the energy detector's decisions."""
    mean_e = energy.mean(dim=-1, keepdim=True)
    min_e = energy.amin(dim=-1, keepdim=True)
    noise = 0.5 * (min_e + torch.minimum(mean_e, 2.0 * min_e))
    occupied = energy > cfg.threshold_ratio * noise
    return {"energy": energy, "noise": noise, "occupied": occupied}


def _stream_blocks(planes, mesh, time_axis, batch_axis, device):
    """This rank's block of the whole input, as contiguous float32 planes on
    ``device``: a stream (T*M,) is cut along ``time_axis``, a batch (B, T*M)
    also along ``batch_axis``."""
    if isinstance(planes, (tuple, list)):
        xr, xi = (torch.as_tensor(v) for v in planes)
        spec = (time_axis,) if xr.dim() == 1 else (batch_axis, time_axis)
        return split_iq((block(xr, mesh, spec, device), block(xi, mesh, spec, device)))
    planes = torch.as_tensor(planes)
    spec = (time_axis,) if planes.dim() == 2 else (batch_axis, time_axis)
    return split_iq(block(planes, mesh, spec, device))


def _check_shard(xr_l: torch.Tensor, cfg: WidebandConfig) -> int:
    """The shard's T, after checking that it holds whole sense cycles."""
    m = cfg.num_channels
    t_local = xr_l.shape[-1] // m
    if xr_l.shape[-1] % m or t_local % cfg.block_len:
        raise ValueError(
            f"a time shard of {xr_l.shape[-1]} wide samples does not hold whole sense cycles "
            f"of {cfg.block_len} x {m}"
        )
    return t_local


def _packed_block(xr_l, xi_l, taps, mesh, cfg, time_axis, precision) -> torch.Tensor:
    """Rank body of the packed energy: the left neighbour's last P-1 phase
    rows seed this shard's FIR (:func:`.halo.left_tail`)."""
    m, p = cfg.num_channels, cfg.taps_per_channel
    _check_shard(xr_l, cfg)
    lead = xr_l.shape[:-1]
    rows = [v[..., xr_l.shape[-1] - (p - 1) * m :].reshape(*lead, p - 1, m) for v in (xr_l, xi_l)]
    hist = left_tail(torch.cat(rows, dim=-1).float(), p - 1, mesh, time_axis, axis=-2)
    return _energy_rows(xr_l, xi_l, taps, cfg.block_len, hist, precision)


def _fused_block(xr_l, xi_l, taps, mesh, cfg, time_axis, precision) -> torch.Tensor:
    """Rank body of the fused energy: kernel 3 on this shard, seeded through
    ``initial_history`` with the left neighbour's last 4 pair rows of each
    plane (zeros on shard 0); one launch per stream of a batched block."""
    m = cfg.num_channels
    t_local = _check_shard(xr_l, cfg)
    _use_fused(cfg, t_local, True)  # raises on a shape the kernel does not take
    lead = xr_l.shape[:-1]
    n = xr_l.shape[-1]
    tails = torch.stack([xr_l[..., n - 8 * m :], xi_l[..., n - 8 * m :]], dim=-2)
    hist = left_tail(tails.reshape(*lead, 2, 4, 2 * m), 4, mesh, time_axis, axis=-2)
    if xr_l.dim() == 1:
        return wideband_energy_fused(
            xr_l, xi_l, taps, cfg, precision=precision, initial_history=(hist[0], hist[1])
        )
    rows = [
        wideband_energy_fused(r, i, taps, cfg, precision=precision, initial_history=(h[0], h[1]))
        for r, i, h in zip(xr_l.reshape(-1, n), xi_l.reshape(-1, n), hist.reshape(-1, 2, 4, 2 * m))
    ]
    cycles = t_local // cfg.block_len
    energy = torch.stack(rows) if rows else xr_l.new_zeros((0, cycles, m))
    return energy.reshape(*lead, cycles, m)


def sharded_wideband_energy_packed(
    xr,
    xi,
    mesh: DeviceMesh,
    cfg: WidebandConfig,
    *,
    time_axis: str = "time",
    batch_axis: str | None = None,
    precision: str = "high",
) -> torch.Tensor:
    """Time-sharded packed energy detector: each shard runs
    :func:`wideband_energy_packed`'s rows on its segment, with the
    cross-shard FIR state, the left neighbour's last P-1 phase rows, brought
    by one ring shift.

    xr/xi: the whole (T*M,) planar stream on every rank, or a (B, T*M)
    batch whose rows are split along ``batch_axis`` (each row a stream of its
    own, its FIR from rest).  Returns this rank's block of the (C, M) /
    (B, C, M) energies, on the planes' device."""
    xr_l, xi_l = _stream_blocks((xr, xi), mesh, time_axis, batch_axis, None)
    taps = torch.from_numpy(cfg.taps()).to(xr_l.device)
    return _packed_block(xr_l, xi_l, taps, mesh, cfg, time_axis, precision)


def sharded_wideband_energy_fused(
    xr,
    xi,
    mesh: DeviceMesh,
    cfg: WidebandConfig,
    *,
    time_axis: str = "time",
    batch_axis: str | None = None,
    precision: str = "high",
) -> torch.Tensor:
    """Time-sharded fused energy detector: each shard runs
    ``wideband_energy_fused`` (kernel 3 on a CUDA tensor, its plain version
    on a CPU one) on its segment; the left neighbour's last 4 pair rows (8
    wide sample times >= the P-1=7 delay taps) come by one ring shift and
    seed the kernel's FIR.  Equal to the kernel on the whole stream.

    Constraints: M=64, P=8; each shard's T a multiple of an even
    ``block_len``.  xr/xi as :func:`sharded_wideband_energy_packed` takes
    them; a batched block launches the kernel once per stream."""
    xr_l, xi_l = _stream_blocks((xr, xi), mesh, time_axis, batch_axis, None)
    taps = torch.from_numpy(cfg.taps()).to(xr_l.device)
    return _fused_block(xr_l, xi_l, taps, mesh, cfg, time_axis, precision)


def _sharded_sense(planes, taps, cfg, mesh, batch_axis, use_fused) -> dict:
    """:func:`wideband_sense` over a mesh before the channel cut: this
    rank's block in, its cycles (and rows) of the outputs over all M
    channels out."""
    taps = torch.as_tensor(taps, dtype=torch.float32)
    xr_l, xi_l = _stream_blocks(planes, mesh, "time", batch_axis, taps.device)
    t_local = _check_shard(xr_l, cfg)
    body = _fused_block if _use_fused(cfg, t_local, use_fused) else _packed_block
    return _decide(body(xr_l, xi_l, taps, mesh, cfg, "time", cfg.precision), cfg)


def make_wideband_fn(
    cfg: WidebandConfig,
    *,
    mesh: DeviceMesh | None = None,
    batch_axis: str | None = None,
    device="cuda",
):
    """The wideband pipeline bound to ``cfg``, its taps on ``device`` (the
    card unless the caller asks for the CPU): ``fn(planes)`` takes what
    :func:`wideband_sense` takes, as tensors or numpy arrays.  Without a
    mesh it moves the input to ``device`` first if it lies elsewhere; with
    ``mesh`` (and ``batch_axis`` for a batch) each rank is given the whole
    input and moves only its block there, and ``fn`` returns the rank's block
    of the outputs."""
    device = torch.device(device)
    taps = torch.from_numpy(cfg.taps()).to(device)

    def place(x):
        x = torch.as_tensor(x)
        return x if mesh is not None else x.to(device)

    @torch.no_grad()
    def fn(planes, *, use_fused: bool | None = None):
        if isinstance(planes, (tuple, list)):
            planes = tuple(place(v) for v in planes)
        else:
            planes = place(planes)
        return wideband_sense(
            planes, taps, cfg, mesh=mesh, batch_axis=batch_axis, use_fused=use_fused
        )

    return fn
