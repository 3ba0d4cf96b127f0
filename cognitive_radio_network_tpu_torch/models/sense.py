"""The fused sense->classify pipeline (port of ``cognitive_radio_network_tpu/models/sense.py``).

The reference's per-node hot path (``ECR_rx_worker``'s sample loop and
``CE_Predictive_Node::execute``'s FFT/feature/MLP chain,
src/extensible_cognitive_radio.cpp:1258-1382; CE_Predictive_Node.cpp:127-289)
as one batched pass over C cycles:

    IQ (C cycles x A buffers x N samples)
      -> 512-point FFT, |X|, mean over A, band sums squared
                             [ops.fused_sense_ct: CUDA kernel on the card]
      -> 4-5-3 sigmoid MLP   [signal.mlp]
      -> occupancy decision + channel policy   [signal.detector]

Decisions per cycle are independent; only the tx-frequency trace carries
state from cycle to cycle (the "else: keep sensing" branch).  The reference
runs it as a ``lax.scan``; here it is one vectorized pass that carries the
last non-zero decision forward with ``cummax`` over cycle indices, so no
Python loop runs per cycle.
"""

from __future__ import annotations

import copy
import dataclasses
import functools

import torch

from cognitive_radio_network_tpu_torch.ops.fused_sense_ct import fused_sense_ct
from cognitive_radio_network_tpu_torch.signal import bands as bands_mod
from cognitive_radio_network_tpu_torch.signal import detector as det
from cognitive_radio_network_tpu_torch.signal.fft import averaged_magnitude_spectrum
from cognitive_radio_network_tpu_torch.signal.iq import split_iq
from cognitive_radio_network_tpu_torch.signal.mlp import OccupancyMLP
from cognitive_radio_network_tpu_torch.utils.device import on_cuda

__all__ = ["SenseConfig", "sense_classify", "sense_classify_trace", "make_sense_fn"]


@dataclasses.dataclass(frozen=True)
class SenseConfig:
    """Static sensing parameters (CE_Predictive_Node.hpp:30-57)."""

    fft_length: int = 512
    averaging: int = 10
    threshold: float = 0.8
    bands: bands_mod.SensingBands = bands_mod.DEFAULT_BANDS
    channels_hz: tuple[float, float, float] = det.SU_CHANNELS_HZ
    sample_rate_hz: float = 13e6
    center_hz: float = 833e6
    sensing_delay_ms: float = 100.0
    # "ct_matmul": Cooley-Tukey N1 x 128 factored DFT (default);
    # "dft_matmul": dense (N, N) DFT matmul; "xla": torch.fft.
    fft_mode: str = "ct_matmul"
    # CUDA tensors with ct_matmul and N=512 go through the fused CUDA kernel
    # (ops/fused_sense_ct.py).  None = auto (CUDA tensors only); False
    # forces the plain graph.
    use_fused_kernel: bool | None = None
    # input transform applied to band features before the MLP: "none" (the
    # reference's raw squared sums, matching its shipped weights) or "log1p"
    # (what training uses; checkpoints record which)
    feature_transform: str = "none"
    # matmul precision of the plain graph: "highest" and "high" are float32
    # with TF32 off, "default" is bf16.  The kernel computes in f32 always.
    precision: str = "high"

    @property
    def samples_per_cycle(self) -> int:
        return self.fft_length * self.averaging


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


@torch.no_grad()
def sense_classify(iq, params: OccupancyMLP, cfg: SenseConfig = SenseConfig()):
    """Batched sense->classify over C cycles.

    iq: planar tuple (xr, xi), each (C*A, N) or (C, A, N) (the kernel's
    layout); complex (C, A, N); or interleaved float32 planes (C, A, N, 2);
    or any flat shape reshapeable to them.  Returns a dict of per-cycle
    tensors: avg_spectrum (C, N), features (C, 4), outputs (C, 3),
    decision (C,) int32.
    """
    n, a = cfg.fft_length, cfg.averaging
    if isinstance(iq, (tuple, list)):  # planar (xr, xi): the kernel's layout
        blocks = tuple(_as_tensor(v).float().reshape(-1, n) for v in iq)
        first = blocks[0]
    else:
        iq = _as_tensor(iq)
        blocks = iq.reshape(-1, a, n) if iq.is_complex() else iq.reshape(-1, a, n, 2)
        first = blocks
    use_fused = cfg.use_fused_kernel
    if use_fused is None:
        use_fused = cfg.fft_mode == "ct_matmul" and n == 512 and on_cuda(first)
    if use_fused:
        xr, xi = blocks if isinstance(blocks, tuple) else split_iq(blocks)
        avg, feats = fused_sense_ct(
            xr.contiguous(),
            xi.contiguous(),
            averaging=a,
            bands=cfg.bands,
            precision=cfg.precision,
        )
    else:
        if isinstance(blocks, tuple):
            blocks = tuple(v.reshape(-1, a, n) for v in blocks)
        avg = averaged_magnitude_spectrum(
            blocks, averaging=a, mode=cfg.fft_mode, precision=cfg.precision
        )
        feats = bands_mod.band_features(avg, cfg.bands)
    mlp_in = torch.log1p(feats) if cfg.feature_transform == "log1p" else feats
    outs = params(mlp_in)
    decision = det.occupancy_decision(outs, cfg.threshold)
    return {
        "avg_spectrum": avg,
        "features": feats,
        "outputs": outs,
        "decision": decision,
    }


def _tx_freq_trace(
    decision: torch.Tensor, initial_tx_freq_hz, channels_hz: tuple[float, float, float]
) -> torch.Tensor:
    """tx_freq[c] = next_tx_channel applied over decision[0..c], vectorized.

    Only the last non-zero decision at or before c matters (0 keeps the
    frequency), so find its index with a running max over the indices of
    the non-zero decisions; cycles before any such decision keep the
    initial frequency.
    """
    idx = torch.arange(decision.shape[0], device=decision.device)
    last = torch.where(decision != det.DECISION_ALL_BUSY, idx, -1).cummax(dim=0).values
    held = torch.where(last >= 0, decision[last.clamp(min=0)], det.DECISION_ALL_BUSY)
    return det.next_tx_channel(held, initial_tx_freq_hz, channels_hz)


def sense_classify_trace(
    iq,
    params: OccupancyMLP,
    initial_tx_freq_hz,
    cfg: SenseConfig = SenseConfig(),
):
    """sense_classify + the stateful tx-frequency trace.

    Returns (results dict, tx_freq trace (C,) float32): tx_freq[c] is the tx
    center frequency after cycle c's decision, with "all busy" keeping the
    previous frequency (CE_Predictive_Node.cpp:245-261).
    """
    res = sense_classify(iq, params, cfg)
    return res, _tx_freq_trace(res["decision"], initial_tx_freq_hz, cfg.channels_hz)


@functools.lru_cache(maxsize=64)
def make_sense_fn(
    cfg: SenseConfig = SenseConfig(), *, with_trace: bool = False, device="cuda"
):
    """A closure over the static config, bound to ``device`` (the card unless
    the caller asks for the CPU; with no card the default raises at the first
    call): ``fn(iq, params)``, or ``fn(iq, params, tx0)`` with
    ``with_trace=True``.  Cached per config and device, as in the reference,
    so engines with one config share one function.

    ``iq`` is what :func:`sense_classify` takes, as tensors or numpy arrays;
    what lies elsewhere is moved to ``device`` first.  ``params`` that lie
    elsewhere are copied there on every call (the caller's module is not
    moved): hand over parameters on ``device`` to pay nothing."""
    device = torch.device(device)

    def place(x):
        return torch.as_tensor(x).to(device)

    def placed(iq, params: OccupancyMLP):
        iq = tuple(place(v) for v in iq) if isinstance(iq, (tuple, list)) else place(iq)
        target = (iq[0] if isinstance(iq, tuple) else iq).device  # "cuda" alone: the current card
        if next(params.parameters()).device != target:
            params = copy.deepcopy(params).to(target)
        return iq, params

    if with_trace:

        def fn(iq, params, tx0):
            iq, params = placed(iq, params)
            return sense_classify_trace(iq, params, tx0, cfg)

        return fn

    def fn(iq, params):
        iq, params = placed(iq, params)
        return sense_classify(iq, params, cfg)

    return fn
