"""Spectrum analyzer, headless (port of ``cognitive_radio_network_tpu/tools/spectrum_analyzer.py``).

The reference ships two generated QT GUI flowgraphs (spectrum_analyzer.py:
USRP source at fc=833e6 / 13 MS/s -> 1024-pt Blackman-Harris FFT + waterfall
+ scope, :29/:505-510; FFT_Analyzer_Band700M/uhd_fft_700M.py: the same at
fc=766e6 / 10 MS/s).  This tool computes the same products (averaged PSD and
waterfall) from a recorded-IQ file or a synthetic scene, batched on the
device the IQ lives on, and renders ASCII or saves npz instead of a QT
window.  The transform is :func:`..signal.fft.spectrum_magnitude` (dense DFT
products in float32), as in the reference, where no kernel computes it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.signal import filters
from cognitive_radio_network_tpu_torch.signal.fft import spectrum_magnitude

__all__ = [
    "SpectrumConfig",
    "BAND_800M",
    "BAND_700M",
    "waterfall",
    "psd",
    "freq_axis_hz",
    "render_ascii",
    "LiveMonitor",
    "scene_source",
    "main",
]


@dataclasses.dataclass(frozen=True)
class SpectrumConfig:
    center_hz: float = 833e6  # spectrum_analyzer.py:29
    sample_rate_hz: float = 13e6
    fft_length: int = 1024  # :505-510
    window: str = "blackman_harris"
    average: int = 8  # FFTs averaged per waterfall row


# the two shipped variants
BAND_800M = SpectrumConfig()
BAND_700M = SpectrumConfig(center_hz=766e6, sample_rate_hz=10e6)


def _window(cfg: SpectrumConfig) -> np.ndarray:
    if cfg.window == "blackman_harris":
        return filters.blackman_harris(cfg.fft_length)
    if cfg.window == "hamming":
        return filters.hamming(cfg.fft_length)
    return np.ones(cfg.fft_length, np.float32)


def waterfall(iq_planes, cfg: SpectrumConfig = BAND_800M) -> torch.Tensor:
    """(n, 2) planes (or complex (n,)) -> (rows, fft_length) PSD dB, fftshifted,
    on the device of the input (numpy input: the CPU).

    One batched pass: window, DFT, magnitude-squared, average, dB."""
    x = torch.as_tensor(iq_planes)
    if x.is_complex():
        x = torch.stack([x.real, x.imag], -1)
    n_fft, avg = cfg.fft_length, cfg.average
    usable = (x.shape[0] // (n_fft * avg)) * n_fft * avg
    blocks = x[:usable].float().reshape(-1, avg, n_fft, 2)
    w = torch.from_numpy(_window(cfg)).to(x.device)[None, None, :, None]
    mags = spectrum_magnitude(blocks * w)
    p = torch.mean(mags * mags, dim=1) / n_fft
    p_db = 10.0 * torch.log10(p + 1e-20)
    return torch.fft.fftshift(p_db, dim=-1)


def psd(iq_planes, cfg: SpectrumConfig = BAND_800M) -> torch.Tensor:
    """Time-averaged PSD in dB (fftshifted)."""
    wf = waterfall(iq_planes, cfg)
    return 10.0 * torch.log10(torch.mean(10.0 ** (wf / 10.0), dim=0) + 1e-20)


def freq_axis_hz(cfg: SpectrumConfig) -> np.ndarray:
    return cfg.center_hz + np.fft.fftshift(np.fft.fftfreq(cfg.fft_length, 1.0 / cfg.sample_rate_hz))


_RAMP = " .:-=+*#%@"


def render_ascii(wf_db, width: int = 100, height: int = 24) -> str:
    """Terminal waterfall: rows = time, columns = frequency."""
    wf = wf_db.cpu().numpy() if isinstance(wf_db, torch.Tensor) else np.asarray(wf_db)
    rs = max(1, wf.shape[0] // height)
    cs = max(1, wf.shape[1] // width)
    img = wf[: rs * height : rs, : cs * width : cs]
    lo, hi = np.percentile(img, 5), np.percentile(img, 99)
    norm = np.clip((img - lo) / max(hi - lo, 1e-9), 0, 1)
    idx = (norm * (len(_RAMP) - 1)).astype(int)
    return "\n".join("".join(_RAMP[i] for i in row) for row in idx)


class LiveMonitor:
    """Live, runtime-tunable terminal waterfall: the interactivity of the
    reference's QT GUI (spectrum_analyzer.py:489-533 exposes center
    frequency, gain, and sample rate as runtime-tunable controls) without
    QT: ANSI rendering, single-key tuning.  Key handling (:meth:`handle_key`)
    and frame production (:meth:`step`) are pure methods over the config
    state, so the interactive behavior is unit-testable without a tty.

    ``source(cfg, n_samples)`` returns IQ planes (a tensor or numpy); each
    block is moved to ``device`` (the card unless the caller asks for the
    CPU) before its waterfall is computed.

    Keys: f/F center freq -step/+step   g/G gain -5/+5 dB
          r/R sample rate /2 | x2       space pause/resume   q quit
    """

    FREQ_STEP_HZ = 1e6  # the reference GUI's _freq_slider step class

    def __init__(self, source, cfg: SpectrumConfig, height: int = 18, *, device="cuda"):
        self.source = source
        self.cfg = cfg
        self.device = torch.device(device)
        self.gain_db = 0.0
        self.paused = False
        self.done = False
        self.height = height
        self._rows = np.full((height, cfg.fft_length), -120.0, np.float32)

    def handle_key(self, ch: str) -> None:
        c = self.cfg
        if ch == "q":
            self.done = True
        elif ch == " ":
            self.paused = not self.paused
        elif ch == "f":
            self.cfg = dataclasses.replace(c, center_hz=c.center_hz - self.FREQ_STEP_HZ)
        elif ch == "F":
            self.cfg = dataclasses.replace(c, center_hz=c.center_hz + self.FREQ_STEP_HZ)
        elif ch == "r":
            self.cfg = dataclasses.replace(c, sample_rate_hz=max(c.sample_rate_hz / 2.0, 1e6))
        elif ch == "R":
            self.cfg = dataclasses.replace(c, sample_rate_hz=c.sample_rate_hz * 2.0)
        elif ch == "g":
            self.gain_db -= 5.0
        elif ch == "G":
            self.gain_db += 5.0

    def step(self, width: int = 100) -> str:
        """Produce one rendered frame (and advance the waterfall unless
        paused).  Returns the full screen string (header + waterfall)."""
        if not self.paused:
            n = self.cfg.fft_length * self.cfg.average * 2
            iq = self.source(self.cfg, n)
            if isinstance(iq, torch.Tensor):
                iq = iq.to(self.device)
            else:  # numpy, maybe read-only (a capture's blocks): copied to the device
                iq = torch.tensor(iq, device=self.device)
            wf = waterfall(iq, self.cfg).cpu().numpy() + self.gain_db
            k = min(len(wf), self.height)
            if len(wf) and self._rows.shape[1] != wf.shape[1]:
                self._rows = np.full((self.height, wf.shape[1]), -120.0, np.float32)
            if k:
                self._rows = np.concatenate([self._rows[k:], wf[-k:]])
        f = self.cfg
        header = (
            f"fc={f.center_hz / 1e6:.1f} MHz  rate={f.sample_rate_hz / 1e6:.1f} "
            f"MS/s  gain={self.gain_db:+.0f} dB  fft={f.fft_length}"
            f"{'  [PAUSED]' if self.paused else ''}   "
            "[f/F freq  r/R rate  g/G gain  space pause  q quit]"
        )
        return header + "\n" + render_ascii(self._rows, width, self.height)

    def run(self, max_steps: int | None = None, interval_s: float = 0.25) -> None:
        """Drive the monitor against the real terminal (raw keys via
        termios when stdin is a tty; plain frame printing otherwise)."""
        import select
        import sys
        import time

        tty_mode = sys.stdin.isatty()
        old = None
        if tty_mode:
            import termios
            import tty as _tty

            old = termios.tcgetattr(sys.stdin)
            _tty.setcbreak(sys.stdin.fileno())
        try:
            steps = 0
            while not self.done and (max_steps is None or steps < max_steps):
                frame = self.step()
                if tty_mode:
                    sys.stdout.write("\x1b[H\x1b[2J" + frame + "\n")
                else:
                    sys.stdout.write(frame + "\n")
                sys.stdout.flush()
                if tty_mode:
                    r, _, _ = select.select([sys.stdin], [], [], interval_s)
                    if r:
                        self.handle_key(sys.stdin.read(1))
                else:
                    time.sleep(interval_s)
                steps += 1
        finally:
            if old is not None:
                import termios

                termios.tcsetattr(sys.stdin, termios.TCSADRAIN, old)


def scene_source(generator: torch.Generator):
    """Demo IQ source: a Markov-PU scene synthesized at the tuned config, on
    the generator's device, each call drawing on from ``generator``.
    Retuning the monitor moves the band edge over the PU channels, the
    behavior an operator uses the reference GUI for (README.md:32-35)."""
    from cognitive_radio_network_tpu_torch.env.pu import markov_pu_trace
    from cognitive_radio_network_tpu_torch.env.scene import (
        SceneConfig,
        occupancy_to_powers,
        synthesize_scene,
    )

    def src(cfg: SpectrumConfig, n: int) -> torch.Tensor:
        cycles = max(n // (cfg.fft_length * cfg.average), 1)
        powers = occupancy_to_powers(markov_pu_trace(generator, cycles), 3, power=0.1)
        return synthesize_scene(
            generator,
            powers,
            cfg.fft_length * cfg.average,
            SceneConfig(sample_rate_hz=cfg.sample_rate_hz, center_hz=cfg.center_hz),
            as_planes=True,
        ).reshape(-1, 2)

    return src


def main(argv=None) -> int:
    import argparse

    from cognitive_radio_network_tpu_torch.utils.device import require_device

    ap = argparse.ArgumentParser(description="headless spectrum analyzer")
    ap.add_argument("input", help="IQ file (raw interleaved f32), or 'demo'")
    ap.add_argument("--band", choices=["800M", "700M"], default="800M")
    ap.add_argument("--fft", type=int, default=1024)
    ap.add_argument("--out", help="save waterfall npz here")
    ap.add_argument(
        "--live",
        action="store_true",
        help="runtime-tunable live waterfall (keys: f/F freq, r/R rate, "
        "g/G gain, space pause, q quit)",
    )
    ap.add_argument("--steps", type=int, default=None, help="with --live: stop after N frames")
    ap.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)

    device = require_device(args.device)
    cfg = dataclasses.replace(BAND_800M if args.band == "800M" else BAND_700M, fft_length=args.fft)
    if args.live:
        if args.input != "demo":
            from cognitive_radio_network_tpu_torch.io.iq import IQReader

            reader = IQReader(args.input)

            def src(c, n):
                blk = reader.read(n)
                if blk is None or blk.shape[0] < n:  # loop the capture
                    reader.cursor.sample_index = 0
                    blk = reader.read(n)
                if blk is None or blk.shape[0] == 0:  # empty capture
                    return np.zeros((n, 2), np.float32)
                return blk

            LiveMonitor(src, cfg, device=device).run(max_steps=args.steps)
        else:
            src = scene_source(torch.Generator(device=device).manual_seed(0))
            LiveMonitor(src, cfg, device=device).run(max_steps=args.steps)
        return 0
    if args.input == "demo":
        from cognitive_radio_network_tpu_torch.env.pu import markov_pu_trace
        from cognitive_radio_network_tpu_torch.env.scene import (
            SceneConfig,
            occupancy_to_powers,
            synthesize_scene,
        )

        trace = markov_pu_trace(torch.Generator(device=device).manual_seed(0), 24)
        iq = synthesize_scene(
            torch.Generator(device=device).manual_seed(1),
            occupancy_to_powers(trace, 3, power=0.1),
            cfg.fft_length * cfg.average,
            SceneConfig(sample_rate_hz=cfg.sample_rate_hz, center_hz=cfg.center_hz),
            as_planes=True,
        ).reshape(-1, 2)
    else:
        from cognitive_radio_network_tpu_torch.io.iq import IQReader

        iq = torch.tensor(IQReader(args.input).read(10_000_000), device=device)
    wf = waterfall(iq, cfg).cpu().numpy()
    print(render_ascii(wf))
    f = freq_axis_hz(cfg)
    print(f"freq {f[0]/1e6:.1f}..{f[-1]/1e6:.1f} MHz, {wf.shape[0]} rows")
    if args.out:
        np.savez(args.out, waterfall_db=wf, freq_hz=f)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
