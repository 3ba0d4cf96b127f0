"""The fused sense->classify pipeline (port of ``cognitive_radio_network_tpu/models/sense.py``).

The reference's per-node hot path (``ECR_rx_worker``'s sample loop and
``CE_Predictive_Node::execute``'s FFT/feature/MLP chain,
src/extensible_cognitive_radio.cpp:1258-1382; CE_Predictive_Node.cpp:127-289)
as one batched pass over C cycles:

    IQ (C cycles x A buffers x N samples)
      -> 512-point FFT, |X|, mean over A, band sums squared
      -> 4-5-3 sigmoid MLP   [signal.mlp]
      -> occupancy decision + channel policy   [signal.detector]

On the fused path (CUDA tensors by default) the whole chain is one launch of
the classify kernel (``ops.fused_sense_ct.fused_sense_classify``), as the
reference compiles it into one jitted program.  Decisions per cycle are
independent; only the tx-frequency trace carries state from cycle to cycle
(the "else: keep sensing" branch).  The reference runs it as a ``lax.scan``;
on the fused path it is a one-block scan kernel (``sense_trace``), otherwise
one vectorized pass that carries the last non-zero decision forward with
``cummax`` over cycle indices, so no Python loop runs per cycle.
"""

from __future__ import annotations

import copy
import dataclasses
import functools

import torch

from cognitive_radio_network_tpu_torch.ops.fused_sense_ct import fused_sense_classify
from cognitive_radio_network_tpu_torch.signal import bands as bands_mod
from cognitive_radio_network_tpu_torch.signal import detector as det
from cognitive_radio_network_tpu_torch.signal.fft import averaged_magnitude_spectrum
from cognitive_radio_network_tpu_torch.signal.iq import split_iq
from cognitive_radio_network_tpu_torch.signal.mlp import OccupancyMLP
from cognitive_radio_network_tpu_torch.utils import profiling
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
    # CUDA tensors with ct_matmul and N=512 go through the fused CUDA kernel,
    # features to decision in one launch (ops/fused_sense_ct.py::
    # fused_sense_classify).  None = auto (CUDA tensors only); False forces
    # the plain graph.
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


_KEYS = ("avg_spectrum", "features", "outputs", "decision")
# the vectorized trace of the plain graph (signal/detector.py)
_tx_freq_trace = det.tx_freq_trace


def _sense(iq, params: OccupancyMLP, cfg: SenseConfig, tx0=None):
    """The results dict, and with ``tx0`` the trace (else None)."""
    n, a = cfg.fft_length, cfg.averaging
    with profiling.span("sense.prepare"):
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
            xr, xi = xr.contiguous(), xi.contiguous()
        elif isinstance(blocks, tuple):
            blocks = tuple(v.reshape(-1, a, n) for v in blocks)
    with profiling.span("sense.classify"), torch.no_grad():
        if use_fused:
            out = fused_sense_classify(
                xr,
                xi,
                params.w1,
                params.b1,
                params.w2,
                params.b2,
                averaging=a,
                bands=cfg.bands,
                threshold=cfg.threshold,
                log1p=cfg.feature_transform == "log1p",
                tx0=tx0,
                channels_hz=cfg.channels_hz,
                precision=cfg.precision,
            )
            return dict(zip(_KEYS, out)), (None if tx0 is None else out[4])
        avg = averaged_magnitude_spectrum(blocks, averaging=a, mode=cfg.fft_mode, precision=cfg.precision)
        feats = bands_mod.band_features(avg, cfg.bands)
        mlp_in = torch.log1p(feats) if cfg.feature_transform == "log1p" else feats
        outs = params(mlp_in)
        decision = det.occupancy_decision(outs, cfg.threshold)
        res = dict(zip(_KEYS, (avg, feats, outs, decision)))
        return res, (None if tx0 is None else _tx_freq_trace(decision, tx0, cfg.channels_hz))


def sense_classify(iq, params: OccupancyMLP, cfg: SenseConfig = SenseConfig()):
    """Batched sense->classify over C cycles.

    iq: planar tuple (xr, xi), each (C*A, N) or (C, A, N) (the kernel's
    layout); complex (C, A, N); or interleaved float32 planes (C, A, N, 2);
    or any flat shape reshapeable to them.  Returns a dict of per-cycle
    tensors: avg_spectrum (C, N), features (C, 4), outputs (C, 3),
    decision (C,) int32.  On the fused path ``params`` must be float32 with
    at most ``ops.fused_sense_ct.MAX_HIDDEN`` hidden units; its tensors are
    read and its ``forward`` is not called.
    """
    return _sense(iq, params, cfg)[0]


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
    ``initial_tx_freq_hz`` is a number or a 0-d tensor; on the fused path a
    0-d tensor on the card is read there, not by the host.
    """
    return _sense(iq, params, cfg, initial_tx_freq_hz)


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
        with profiling.span("sense.upload"):
            return torch.as_tensor(x).to(device)

    def placed(iq, params: OccupancyMLP):
        with profiling.span("sense.place"):
            iq = tuple(place(v) for v in iq) if isinstance(iq, (tuple, list)) else place(iq)
            target = (iq[0] if isinstance(iq, tuple) else iq).device  # "cuda" alone: the current card
            if params.w1.device != target:
                params = copy.deepcopy(params).to(target)
            return iq, params

    if with_trace:

        def fn(iq, params, tx0):
            with profiling.span("sense.call"):
                iq, params = placed(iq, params)
                return sense_classify_trace(iq, params, tx0, cfg)

        return fn

    def fn(iq, params):
        with profiling.span("sense.call"):
            iq, params = placed(iq, params)
            return sense_classify(iq, params, cfg)

    return fn
