"""The fused sense chain: IQ rows -> averaged spectrum + band features.

Port of ``cognitive_radio_network_tpu/ops/fused_sense_ct.py`` (the Pallas
TPU kernel ``_kernel``) to a CUDA C++ kernel for Hopper,
``csrc/fused_sense_ct.cu``.  Per cycle of A buffers of 512 samples it
computes the sensing math of CE_Predictive_Node.cpp:146-197:

    512-point FFT of each row -> |X| -> mean over the A rows -> band
    amplitude sums through the (512, 4) indicator matrix -> squared

:func:`ct_band_features` returns the features alone.

:func:`fused_sense_ct` launches the kernel for CUDA tensors and runs
:func:`fused_sense_ct_plain`, the plain PyTorch version of the same contract
(radix-4 -> twiddle -> 128-point DFT matmul -> |X| -> mean -> band matmul ->
square), for CPU tensors.  The choice follows the tensor's device only; on a
CUDA tensor the wrapper launches the kernel or raises.

The kernel computes in float32 at every ``precision``; the argument selects
the matmul precision of the plain version only.  The kernel's source note
says what bounds it on the card.

:func:`fused_sense_classify` launches the classify form of the same kernel,
which also runs the rest of the sense chain per cycle (``log1p`` when asked,
the 4-H-3 sigmoid MLP, the occupancy decision), and with ``tx0`` the retune
trace (:func:`sense_trace`, a one-block scan kernel): one launch per
sense->classify dispatch, two with the trace.  Its plain version,
:func:`fused_sense_classify_plain`, is the eager chain the sense pipeline ran
before: :func:`fused_sense_ct_plain`, the MLP of ``signal/mlp.py``,
``occupancy_decision`` and ``tx_freq_trace``.
"""

from __future__ import annotations

import torch

from cognitive_radio_network_tpu_torch.ops._launch import input_ptr, launch
from cognitive_radio_network_tpu_torch.ops._sense import N as _N
from cognitive_radio_network_tpu_torch.ops._sense import band_matrix, count_rows, twiddles
from cognitive_radio_network_tpu_torch.signal import bands as bands_mod
from cognitive_radio_network_tpu_torch.signal.detector import (
    SU_CHANNELS_HZ,
    occupancy_decision,
    tx_freq_trace,
)
from cognitive_radio_network_tpu_torch.signal.fft import PRECISIONS, spectrum_magnitude
from cognitive_radio_network_tpu_torch.signal.mlp import mlp_apply
from cognitive_radio_network_tpu_torch.utils.device import on_cuda

__all__ = [
    "MAX_HIDDEN",
    "ct_band_features",
    "fused_sense_classify",
    "fused_sense_classify_plain",
    "fused_sense_ct",
    "fused_sense_ct_plain",
    "sense_trace",
    "sense_trace_plain",
]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
MAX_HIDDEN = 32  # csrc/fused_sense_ct.cu kMaxHidden: a hidden unit per lane of one warp


def _rows(xr: torch.Tensor, xi: torch.Tensor, averaging: int):
    """Check the planar input; return it buffers-flat (C*A, N) with A."""
    rows, averaging = count_rows(xr, xi, averaging, "fused_sense_ct")
    return xr.reshape(rows, _N), xi.reshape(rows, _N), averaging


def fused_sense_ct_plain(
    xr: torch.Tensor,
    xi: torch.Tensor,
    *,
    averaging: int = 10,
    bands: bands_mod.SensingBands = bands_mod.DEFAULT_BANDS,
    precision: str = "high",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (avg (C, 512), feats (C, 4)), float32.

    bf16 input is upcast first, as the kernel does after its load.
    """
    xr, xi, a = _rows(xr, xi, averaging)
    mags = spectrum_magnitude((xr.float(), xi.float()), mode="ct_matmul", precision=precision)
    avg = mags.reshape(-1, a, _N).mean(dim=1)
    return avg, bands_mod.band_features(avg, bands)


def fused_sense_ct(
    xr: torch.Tensor,
    xi: torch.Tensor,
    *,
    averaging: int = 10,
    bands: bands_mod.SensingBands = bands_mod.DEFAULT_BANDS,
    precision: str = "high",
) -> tuple[torch.Tensor, torch.Tensor]:
    """IQ for C cycles -> (avg_spectrum (C, 512), features (C, 4)), float32.

    ``xr``, ``xi``: planar planes, buffers-flat (C*A, 512) (the layout the
    kernel reads) or (C, A, 512), float32 or bfloat16.  CPU tensors run
    :func:`fused_sense_ct_plain`.  CUDA tensors launch the kernel on the
    current stream, without synchronizing; they must be contiguous (the
    kernel loads scalars: any alignment of the element type).  Each launch adds one to ``fused_sense_ct.launches``.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of {PRECISIONS}")
    if not on_cuda(xr):
        return fused_sense_ct_plain(xr, xi, averaging=averaging, bands=bands, precision=precision)
    dev = xr.device
    if xr.dtype not in _KERNEL_DTYPES or xi.dtype != xr.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16 planes, got {xr.dtype}, {xi.dtype}")
    p_xr = input_ptr(xr, "xr", dev)
    p_xi = input_ptr(xi, "xi", dev)
    # contiguous: (C, A, N) is (C*A, N) in memory
    rows, a = count_rows(xr, xi, averaging, "fused_sense_ct")
    band = band_matrix(bands, dev)
    c = rows // a
    avg = xr.new_empty((c, _N), dtype=torch.float32)
    feats = xr.new_empty((c, 4), dtype=torch.float32)
    if c == 0:
        return avg, feats
    launch(
        "crn_fused_sense_ct", dev,
        p_xr, p_xi, int(xr.dtype == torch.bfloat16), twiddles(dev).data_ptr(), band.data_ptr(),
        avg.data_ptr(), feats.data_ptr(), c, a,
    )
    fused_sense_ct.launches += 1
    return avg, feats


fused_sense_ct.launches = 0


def ct_band_features(iq_planes, **kw) -> torch.Tensor:
    """Features only: (C, 4) float32, a drop-in for
    :func:`..fused_sense.fused_band_features`.  ``iq_planes`` is a planar
    ``(xr, xi)`` tuple as :func:`fused_sense_ct` takes it, or (C, A, N, 2)
    planes (A from the shape, de-interleaved with one copy per plane);
    ``kw`` goes to :func:`fused_sense_ct`."""
    if isinstance(iq_planes, (tuple, list)):
        xr, xi = iq_planes
    else:
        if iq_planes.dim() != 4 or iq_planes.shape[-1] != 2:
            raise ValueError(f"expected (C, A, N, 2) planes, got {tuple(iq_planes.shape)}")
        xr, xi = iq_planes[..., 0].contiguous(), iq_planes[..., 1].contiguous()
    return fused_sense_ct(xr, xi, **kw)[1]


def _hidden(w1, b1, w2, b2) -> int:
    """Check the MLP's weights against the classify kernel's contract, on
    either device; return H."""
    for what, w in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if w.dtype != torch.float32:
            raise TypeError(f"the sense tail takes float32 weights, got {what} {w.dtype}")
    h = w1.shape[-1]
    if (w1.dim() != 2 or w1.shape[0] != 4 or not 1 <= h <= MAX_HIDDEN or b1.shape != (h,)
            or w2.shape != (h, 3) or b2.shape != (3,)):
        raise ValueError(
            f"the sense tail takes w1 (4, H), b1 (H,), w2 (H, 3), b2 (3,) with 1 <= H <= "
            f"{MAX_HIDDEN}; got w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)}, "
            f"b2 {tuple(b2.shape)}"
        )
    return h


# the plain PyTorch version of the trace kernel
sense_trace_plain = tx_freq_trace


def sense_trace(
    decision: torch.Tensor, tx0, channels_hz=SU_CHANNELS_HZ, *, out: torch.Tensor | None = None
) -> torch.Tensor:
    """The tx frequency after each cycle, (C,) float32: the channel that the
    last non-zero decision at or before the cycle selects (1 -> channels[1],
    2 -> channels[0], 3 -> channels[1]), or ``tx0`` before any.

    ``decision``: (C,) int32.  CPU tensors run :func:`sense_trace_plain`.  On
    the card one block scans the decisions (one launch, on the current
    stream, into ``out`` when given).  ``tx0`` is a number, or a 0-d tensor:
    one on the card is read there by the kernel, never by the host (a dtype
    other than float32 costs one conversion on the card); one on the host is
    passed by value.  Each launch adds one to ``sense_trace.launches``.
    """
    if not on_cuda(decision):
        return sense_trace_plain(decision, tx0, channels_hz)
    dev = decision.device
    if decision.dtype != torch.int32 or decision.dim() != 1:
        raise TypeError(f"sense_trace takes (C,) int32 decisions, got {decision.dtype} "
                        f"{tuple(decision.shape)}")
    p_dec = input_ptr(decision, "decision", dev)
    c = decision.shape[0]
    if out is None:
        out = decision.new_empty(c, dtype=torch.float32)
    elif out.dtype != torch.float32 or out.shape != (c,):
        raise ValueError(f"out must be ({c},) float32, got {out.dtype} {tuple(out.shape)}")
    p_out = input_ptr(out, "out", dev)
    p_tx0, v_tx0 = None, 0.0
    if isinstance(tx0, torch.Tensor) and tx0.device.type != "cpu":
        if tx0.dim() != 0:
            raise ValueError(f"tx0 must be a number or a 0-d tensor, got {tuple(tx0.shape)}")
        tx0 = tx0 if tx0.dtype == torch.float32 else tx0.float()
        p_tx0 = input_ptr(tx0, "tx0", dev)
    else:
        v_tx0 = float(tx0)
    if c == 0:
        return out
    launch("crn_sense_trace", dev, p_dec, c, p_tx0, v_tx0, float(channels_hz[0]),
           float(channels_hz[1]), p_out)
    sense_trace.launches += 1
    return out


sense_trace.launches = 0


@torch.no_grad()  # as the kernel: no gradient
def fused_sense_classify_plain(
    xr: torch.Tensor,
    xi: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    *,
    averaging: int = 10,
    bands: bands_mod.SensingBands = bands_mod.DEFAULT_BANDS,
    threshold: float = 0.8,
    log1p: bool = False,
    tx0=None,
    channels_hz=SU_CHANNELS_HZ,
    precision: str = "high",
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the classify kernel: (avg (C, 512), feats
    (C, 4), outputs (C, 3), decision (C,) int32), and with ``tx0`` the trace
    (C,) float32 last."""
    avg, feats = fused_sense_ct_plain(xr, xi, averaging=averaging, bands=bands, precision=precision)
    outputs = mlp_apply(torch.log1p(feats) if log1p else feats, w1, b1, w2, b2)
    decision = occupancy_decision(outputs, threshold)
    if tx0 is None:
        return avg, feats, outputs, decision
    return avg, feats, outputs, decision, sense_trace_plain(decision, tx0, channels_hz)


def fused_sense_classify(
    xr: torch.Tensor,
    xi: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    *,
    averaging: int = 10,
    bands: bands_mod.SensingBands = bands_mod.DEFAULT_BANDS,
    threshold: float = 0.8,
    log1p: bool = False,
    tx0=None,
    channels_hz=SU_CHANNELS_HZ,
    precision: str = "high",
) -> tuple[torch.Tensor, ...]:
    """IQ for C cycles -> (avg (C, 512), feats (C, 4), outputs (C, 3),
    decision (C,) int32), and with ``tx0`` the retune trace (C,) float32.

    The planes are what :func:`fused_sense_ct` takes.  ``w1`` (4, H), ``b1``
    (H,), ``w2`` (H, 3), ``b2`` (3,) are float32 with 1 <= H <=
    :data:`MAX_HIDDEN` (checked on either device).  ``log1p`` feeds log1p of
    the features to the MLP; ``threshold`` is compared in float32; ``tx0``
    and ``channels_hz`` are :func:`sense_trace`'s.  CPU tensors run
    :func:`fused_sense_classify_plain`.  CUDA tensors launch the classify
    kernel (adding one to ``fused_sense_ct.launches``), then with ``tx0`` the
    trace kernel, on the current stream, without synchronizing; the outputs
    are views of one allocation.
    """
    hidden = _hidden(w1, b1, w2, b2)
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of {PRECISIONS}")
    if not on_cuda(xr):
        return fused_sense_classify_plain(
            xr, xi, w1, b1, w2, b2, averaging=averaging, bands=bands, threshold=threshold,
            log1p=log1p, tx0=tx0, channels_hz=channels_hz, precision=precision,
        )
    dev = xr.device
    if xr.dtype not in _KERNEL_DTYPES or xi.dtype != xr.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16 planes, got {xr.dtype}, {xi.dtype}")
    p_xr = input_ptr(xr, "xr", dev)
    p_xi = input_ptr(xi, "xi", dev)
    p_w = [input_ptr(w, what, dev) for what, w in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2))]
    rows, a = count_rows(xr, xi, averaging, "fused_sense_classify")
    band = band_matrix(bands, dev)
    c = rows // a
    # one allocation: avg | feats | outputs | decision (int32 bits) | trace,
    # cut by as_strided (a slice and a view cost the host twice as much)
    buf = xr.new_empty(c * (_N + 9 if tx0 is not None else _N + 8), dtype=torch.float32)
    avg = buf.as_strided((c, _N), (_N, 1))
    feats = buf.as_strided((c, 4), (4, 1), c * _N)
    outputs = buf.as_strided((c, 3), (3, 1), c * (_N + 4))
    decision = buf.as_strided((c,), (1,), c * (_N + 7)).view(torch.int32)
    if c > 0:
        launch(
            "crn_fused_sense_classify", dev,
            p_xr, p_xi, int(xr.dtype == torch.bfloat16), twiddles(dev).data_ptr(), band.data_ptr(),
            *p_w, hidden, int(log1p), float(threshold), avg.data_ptr(), feats.data_ptr(),
            outputs.data_ptr(), decision.data_ptr(), c, a,
        )
        fused_sense_ct.launches += 1
    if tx0 is None:
        return avg, feats, outputs, decision
    trace = sense_trace(decision, tx0, channels_hz, out=buf.as_strided((c,), (1,), c * (_N + 8)))
    return avg, feats, outputs, decision, trace
