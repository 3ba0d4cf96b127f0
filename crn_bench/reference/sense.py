"""The sensing cells' inputs and their plain reference.

:func:`make_scene` synthesizes what a CE_Predictive_Node hears at 833 MHz and
13 MS/s: per sensing cycle (``averaging`` buffers of ``fft_length`` samples,
contiguous) each of the three channels carries a primary user with a
probability, at a power drawn log-uniformly, as band-limited complex noise of
the primary user's bandwidth (white noise shaped by a band mask over the
cycle's spectrum), over a complex Gaussian noise floor.  It runs on the
generator's device in float32 and returns the planar (xr, xi) rows the sense
pipeline takes.

:func:`sense_reference` is the CE_Predictive_Node chain as written
(CE_Predictive_Node.cpp:146-261): a 512-point FFT of every buffer, |X|
averaged over the cycle's buffers, the band amplitude sums squared into
[NF, CH1, CH2, CH3], the 4-5-3 sigmoid MLP, and the first output at or above
the threshold as the decision.  It computes in float64 from the same planes,
in blocks of cycles, on their device.  Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch


def make_scene(gen: torch.Generator, cycles: int, sense: dict, scene: dict,
               block: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """(xr, xi), each float32 (cycles * averaging, fft_length), on ``gen``'s device."""
    a, n = sense["averaging"], sense["fft_length"]
    span = a * n
    dev = gen.device
    freqs = torch.fft.fftfreq(span, d=1.0 / sense["sample_rate_hz"], device=dev, dtype=torch.float64)
    masks = []
    for ch in sense["channels_hz"]:
        off = ch - sense["center_hz"]
        masks.append((freqs - off).abs() <= scene["pu_bandwidth_hz"] / 2)
    masks = torch.stack(masks).float()  # (3, span)
    masks = masks / masks.sum(1, keepdim=True).sqrt() * np.sqrt(span)  # unit power per channel
    lo_db, hi_db = scene["pu_power_db"]
    xr = torch.empty(cycles * a, n, device=dev)
    xi = torch.empty(cycles * a, n, device=dev)
    floor = float(np.sqrt(10.0 ** (scene["noise_floor_db"] / 10.0) / 2))
    for c0 in range(0, cycles, block):
        c = min(block, cycles - c0)
        busy = torch.rand(c, 3, generator=gen, device=dev) < scene["pu_busy_probability"]
        power_db = lo_db + (hi_db - lo_db) * torch.rand(c, 3, generator=gen, device=dev)
        amp = torch.where(busy, 10.0 ** (power_db / 20.0), 0.0)  # (c, 3)
        white = torch.complex(torch.randn(c, span, generator=gen, device=dev),
                              torch.randn(c, span, generator=gen, device=dev)) / np.sqrt(2)
        shaped = torch.fft.ifft(torch.fft.fft(white) * (amp @ masks)[:, :], dim=-1)
        x = shaped + floor * torch.complex(torch.randn(c, span, generator=gen, device=dev),
                                           torch.randn(c, span, generator=gen, device=dev))
        rows = slice(c0 * a, (c0 + c) * a)
        xr[rows] = x.real.reshape(c * a, n)
        xi[rows] = x.imag.reshape(c * a, n)
    return xr, xi


def band_matrix(sense: dict, dtype=torch.float64, device=None) -> torch.Tensor:
    """(fft_length, 4) 0/1 columns [NF, CH1, CH2, CH3] from the config's bin ranges."""
    m = torch.zeros(sense["fft_length"], 4, dtype=dtype, device=device)
    for col, key in enumerate(("noise_floor", "ch1", "ch2", "ch3")):
        for lo, hi in sense["bands"][key]:
            m[lo:hi, col] = 1.0
    return m


def mlp_reference(features: torch.Tensor, mlp: dict) -> torch.Tensor:
    """Sigmoid hidden and output layers over (..., 4) float64 features."""
    dt, dev = features.dtype, features.device
    w1, b1, w2, b2 = (torch.tensor(mlp[k], dtype=dt, device=dev) for k in ("w1", "b1", "w2", "b2"))
    h = torch.sigmoid(features @ w1 + b1)
    return torch.sigmoid(h @ w2 + b2)


def decision_reference(outputs: torch.Tensor, threshold: float) -> torch.Tensor:
    """First output at or above the threshold, 1-indexed; 0 when none is."""
    hit = outputs >= threshold
    first = torch.where(hit.any(-1), hit.to(torch.int8).argmax(-1) + 1, 0)
    return first.to(torch.int32)


def sense_reference(xr: torch.Tensor, xi: torch.Tensor, sense: dict, mlp: dict,
                    block: int = 512) -> dict[str, torch.Tensor]:
    """The chain over the cycles of (xr, xi): avg_spectrum (C, N), features
    (C, 4), outputs (C, 3) in float64 and decision (C,) int32, on the planes' device."""
    a, n = sense["averaging"], sense["fft_length"]
    cycles = xr.shape[0] // a
    bands = band_matrix(sense, device=xr.device)
    outs = {"avg_spectrum": [], "features": [], "outputs": [], "decision": []}
    for c0 in range(0, cycles, block):
        rows = slice(c0 * a, min(cycles, c0 + block) * a)
        x = torch.complex(xr[rows].double(), xi[rows].double())
        avg = torch.fft.fft(x, dim=-1).abs().reshape(-1, a, n).mean(1)
        feats = (avg @ bands) ** 2
        o = mlp_reference(feats, mlp)
        for k, v in zip(outs, (avg, feats, o, decision_reference(o, sense["threshold"]))):
            outs[k].append(v)
    return {k: torch.cat(v) for k, v in outs.items()}
