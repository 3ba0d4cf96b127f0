"""The wideband cell's inputs and its plain reference.

:func:`make_capture` synthesizes what a 64-channel wideband monitor hears at
833 MHz and 13 MS/s: per stream, sense cycle after sense cycle
(``block_len`` x M wide samples, contiguous), each primary user of the scene
is on with a probability, at a power drawn uniformly in dB, as band-limited
complex noise of the primary user's bandwidth (white noise shaped by a band
mask over the cycle's spectrum), over a complex Gaussian noise floor.  Its
users sit at the configured channels and at further centers drawn from the
generator across the band.  It runs on the generator's device in float32 and
returns interleaved (streams, N, 2) planes, UHD's fc32 layout.

:func:`wideband_reference` is the polyphase channelizer as described, in
float64, written from the description and not from the program:

- the prototype (:func:`prototype`): a windowed sinc of length M*P with
  cutoff 1/(2M) cycles a sample, a Kaiser window of beta 0.1102 (A - 8.7)
  for A = 70 dB, scaled to unit DC gain (the sum of its taps is 1);
  ``h[p, c] = proto[p M + c]``;
- the commutator form of the analysis on the continuous stream:
  ``xp[t, c] = x[t M + c]``, ``v[t, c] = sum_p h[p, c] xp[t - p, c]`` and
  ``y[t, k] = sum_c v[t, c] exp(-2 pi i c k / M)``;
- per cycle the mean of ``|y|^2`` over its ``block_len`` rows, the noise
  floor ``0.5 (min + min(mean, 2 min))`` across the channels, and the
  decisions ``E > threshold_ratio * noise``.

The rows before a block are those of the block before it on the tape
(``history``); the first block of a stream starts from rest.  It computes on
the planes' device, a few streams at a time.  Departure: the program holds
its taps in float32, the reference keeps them in float64 (a relative 6e-8).
Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch


def kaiser_beta(attenuation_db: float) -> float:
    """Kaiser's beta for a stop-band attenuation in dB (Kaiser's formula)."""
    a = attenuation_db
    if a > 50:
        return 0.1102 * (a - 8.7)
    if a >= 21:
        return 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21)
    return 0.0


def prototype(m: int, p: int, attenuation_db: float = 70.0) -> np.ndarray:
    """(M*P,) float64 prototype low-pass: windowed sinc, cutoff 1/(2M), Kaiser, unit DC gain."""
    length = m * p
    n = np.arange(length) - (length - 1) / 2
    cutoff = 0.5 / m
    ideal = 2 * cutoff * np.sinc(2 * cutoff * n)
    window = np.i0(kaiser_beta(attenuation_db) * np.sqrt(1 - (2 * n / (length - 1)) ** 2))
    h = ideal * window
    return h / h.sum()


def make_capture(gen: torch.Generator, streams: int, cycles: int, config: dict,
                 centers_hz: list[float], block: int = 2048) -> torch.Tensor:
    """(streams, cycles * block_len * M, 2) float32 planes on ``gen``'s device;
    ``centers_hz`` are the primary users' carriers (see :func:`pu_centers`)."""
    wb, scene = config["wideband"], config["scene"]
    span = wb["block_len"] * wb["num_channels"]  # wide samples a cycle
    dev = gen.device
    freqs = torch.fft.fftfreq(span, d=1.0 / config["sample_rate_hz"], device=dev, dtype=torch.float64)
    masks = torch.stack([(freqs - (c - config["center_hz"])).abs() <= scene["pu_bandwidth_hz"] / 2
                         for c in centers_hz]).float()
    masks = masks / masks.sum(1, keepdim=True).sqrt() * np.sqrt(span)  # unit power per user
    lo_db, hi_db = scene["pu_power_db"]
    floor = float(np.sqrt(10.0 ** (scene["noise_floor_db"] / 10.0) / 2))
    n_pu = len(centers_hz)
    out = torch.empty(streams * cycles, span, 2, device=dev)
    for c0 in range(0, streams * cycles, block):
        c = min(block, streams * cycles - c0)
        busy = torch.rand(c, n_pu, generator=gen, device=dev) < scene["pu_busy_probability"]
        power_db = lo_db + (hi_db - lo_db) * torch.rand(c, n_pu, generator=gen, device=dev)
        amp = torch.where(busy, 10.0 ** (power_db / 20.0), 0.0)
        white = torch.complex(torch.randn(c, span, generator=gen, device=dev),
                              torch.randn(c, span, generator=gen, device=dev)) / np.sqrt(2)
        x = torch.fft.ifft(torch.fft.fft(white) * (amp @ masks), dim=-1)
        x = x + floor * torch.complex(torch.randn(c, span, generator=gen, device=dev),
                                      torch.randn(c, span, generator=gen, device=dev))
        out[c0:c0 + c] = torch.view_as_real(x)
        del white, x
    return out.reshape(streams, cycles * span, 2)


def pu_centers(gen: torch.Generator, config: dict) -> list[float]:
    """The configured channels, then ``extra_pus`` carriers drawn uniformly
    where a user's whole band lies inside the monitored band."""
    scene = config["scene"]
    half = config["sample_rate_hz"] / 2 - scene["pu_bandwidth_hz"] / 2
    draws = torch.rand(scene["extra_pus"], generator=gen, device=gen.device).double().cpu()
    return list(scene["pu_channels_hz"]) + [config["center_hz"] - half + 2 * half * float(u)
                                           for u in draws]


def wideband_reference(planes: torch.Tensor, history: torch.Tensor | None, wb: dict,
                       block: int = 4) -> dict[str, torch.Tensor]:
    """Energy (B, C, M) and noise (B, C, 1) float64, occupied (B, C, M) bool of
    the (B, N, 2) planes, on their device; ``history`` (B, R, 2), R >= (P-1) M,
    holds the wide samples before each stream (None: from rest)."""
    m, p, bl = wb["num_channels"], wb["taps_per_channel"], wb["block_len"]
    h = torch.from_numpy(prototype(m, p)).reshape(p, m).to(planes.device)
    b_total, n = planes.shape[0], planes.shape[1]
    t = n // m
    outs = {"energy": [], "noise": [], "occupied": []}
    for b0 in range(0, b_total, block):
        x = torch.view_as_complex(planes[b0:b0 + block].double().contiguous()).reshape(-1, t, m)
        if history is None:
            before = x.new_zeros(x.shape[0], p - 1, m)
        else:
            hist = torch.view_as_complex(history[b0:b0 + block].double().contiguous())
            before = hist[:, hist.shape[1] - (p - 1) * m:].reshape(-1, p - 1, m)
        ext = torch.cat([before, x], dim=1)  # rows t - P + 1 .. T - 1
        v = sum(h[q] * ext[:, p - 1 - q: p - 1 - q + t] for q in range(p))
        y = torch.fft.fft(v, dim=-1)  # sum_c v[t, c] exp(-2 pi i c k / M)
        energy = (y.real ** 2 + y.imag ** 2).reshape(-1, t // bl, bl, m).mean(dim=2)
        lo = energy.amin(-1, keepdim=True)
        noise = 0.5 * (lo + torch.minimum(energy.mean(-1, keepdim=True), 2 * lo))
        for k, val in zip(outs, (energy, noise, energy > wb["threshold_ratio"] * noise)):
            outs[k].append(val)
        del x, ext, v, y
    return {k: torch.cat(v) for k, v in outs.items()}
