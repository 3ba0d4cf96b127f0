#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: build, check, drive, time.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card.  Each phase prints
one line; any failure raises, and the exit code is then non-zero.

1. device and build: the card's name and power limit; builds the kernels of
   ``cognitive_radio_network_tpu_torch/csrc`` into ``build/kernels``.
2. kernel vs plain: ``fused_sense_ct`` against ``fused_sense_ct_plain`` on
   the same card (TF32 off) at C=4096 and C=5 cycles (f32 input), and with
   bf16 input at ``precision="default"``.
3. golden gate: 16 cycles of a synthesized PU scene through
   ``make_sense_fn(SenseConfig())``, held to ``tests/golden_reference.py``.
4. main path: a Markov PU trace drives ``synthesize_scene`` and
   ``sense_classify_trace`` over 4096 cycles in one dispatch; the kernel's
   launch count must rise, decisions must track the PU channel and the tx
   trace must follow the retune policy.
5. CLI: a 4096-cycle capture through ``python -m
   cognitive_radio_network_tpu_torch sense`` at 256 cycles per dispatch.
6. times: median of 3 for the kernel and the plain version at C=4096 and
   C=256, with CUDA events.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "cognitive_radio_network_tpu_torch/csrc/fused_sense_ct.cu"
KERNEL_REPLACES = "cognitive_radio_network_tpu/ops/fused_sense_ct.py:51"
CYCLES = 4096  # cycles per dispatch of the reference's bench (bench.py:132)
CLI_CYCLES = 256  # the sense CLI's default cycles per dispatch


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def time_ms(fn, inputs, trials: int = 3, reps: int = 10) -> list[float]:
    """Mean time per call in each of ``trials`` runs of ``reps`` calls, by CUDA events.

    ``inputs`` is a list of argument tuples used in turn, so a set of
    buffers larger than the 50 MB L2 cache reaches the kernel cold."""
    import torch

    for args in inputs:  # warm-up
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(reps):
            fn(*inputs[i % len(inputs)])
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return times


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))  # golden_reference.py: numpy only
    import golden_reference as gold

    from cognitive_radio_network_tpu_torch.env import markov_pu_trace
    from cognitive_radio_network_tpu_torch.env.scene import occupancy_to_powers, synthesize_scene
    from cognitive_radio_network_tpu_torch.io.iq import IQWriter
    from cognitive_radio_network_tpu_torch.models import (
        SenseConfig,
        make_sense_fn,
        sense_classify_trace,
    )
    from cognitive_radio_network_tpu_torch.ops import _build
    from cognitive_radio_network_tpu_torch.ops.fused_sense_ct import (
        fused_sense_ct,
        fused_sense_ct_plain,
    )
    from cognitive_radio_network_tpu_torch.signal.mlp import reference_weights

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = SenseConfig()
    a, n = cfg.averaging, cfg.fft_length

    # 1. device and build
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    phase("device", f"{name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)
    lib_path = _build.library_path()
    t0 = time.perf_counter()
    if not lib_path.exists():
        proc = _build.build(lib_path, extra_flags=("-Xptxas", "-v"))
        for line in (proc.stdout + proc.stderr).splitlines():
            if "registers" in line or "spill" in line:
                phase("build", line.strip())
    _build.load()
    phase("build", f"{lib_path.relative_to(ROOT)} ready in {time.perf_counter() - t0:.1f} s")

    # 2. kernel vs plain on the card
    gen = torch.Generator(device=dev).manual_seed(0)

    def planes(c: int):
        return (
            torch.randn(c * a, n, generator=gen, device=dev),
            torch.randn(c * a, n, generator=gen, device=dev),
        )

    max_abs_err = 0.0
    for c in (CYCLES, 5):
        xr, xi = planes(c)
        avg_k, feats_k = fused_sense_ct(xr, xi, averaging=a)
        avg_p, feats_p = fused_sense_ct_plain(xr, xi, averaging=a)
        torch.cuda.synchronize()
        torch.testing.assert_close(avg_k, avg_p, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(feats_k, feats_p, rtol=1e-4, atol=0.0)
        err = (avg_k - avg_p).abs().max().item()
        max_abs_err = max(max_abs_err, err)
        frel = ((feats_k - feats_p).abs() / feats_p.abs()).max().item()
        phase("kernel-vs-plain", f"f32 C={c}: avg max abs err {err:.3e} (rtol 1e-4, atol 1e-5), "
              f"feats max rel err {frel:.3e} (rtol 1e-4)")
    xr, xi = planes(CYCLES)
    _, feats_f32 = fused_sense_ct_plain(xr, xi, averaging=a)
    _, feats_bf = fused_sense_ct(xr.bfloat16(), xi.bfloat16(), averaging=a, precision="default")
    torch.cuda.synchronize()
    torch.testing.assert_close(feats_bf, feats_f32, rtol=2e-2, atol=0.0)
    frel = ((feats_bf - feats_f32).abs() / feats_f32.abs()).max().item()
    phase("kernel-vs-plain", f"bf16 C={CYCLES} precision=default: feats max rel err {frel:.3e} "
          f"vs f32 (rtol 2e-2)")
    del xr, xi

    # 3. golden gate (port of tests/tpu_gates.py::gate_fused_sense)
    params = reference_weights(device=dev)
    fn = make_sense_fn(cfg)
    rng = np.random.default_rng(0)
    gc = 16
    gtrace = torch.as_tensor(rng.integers(0, 3, size=gc), device=dev)
    g_planes = synthesize_scene(
        torch.Generator(device=dev).manual_seed(7),
        occupancy_to_powers(gtrace, 3, power=0.05),
        cfg.samples_per_cycle,
        as_planes=True,
    )
    g_np = g_planes.cpu().numpy().reshape(gc, a, n, 2)
    g_out = fn(
        (
            torch.from_numpy(g_np[..., 0].reshape(-1, n).copy()).to(dev),
            torch.from_numpy(g_np[..., 1].reshape(-1, n).copy()).to(dev),
        ),
        params,
    )
    g_out = {k: v.cpu().numpy() for k, v in g_out.items()}
    feats_ref, outs_ref, decs_ref = gold.sense_classify_reference(g_np[..., 0] + 1j * g_np[..., 1])
    np.testing.assert_allclose(g_out["features"], feats_ref, rtol=5e-3)
    np.testing.assert_allclose(g_out["outputs"], outs_ref, atol=2e-3)
    if not np.array_equal(g_out["decision"], decs_ref):
        raise AssertionError("on-card sense decisions diverge from the golden reference")
    phase("golden", f"{gc} cycles: features rtol 5e-3, outputs atol 2e-3, decisions equal "
          f"{g_out['decision'].tolist()}")

    # 4. the main path at full size
    gen = torch.Generator(device=dev).manual_seed(42)
    trace = markov_pu_trace(gen, CYCLES)
    scene = synthesize_scene(
        gen, occupancy_to_powers(trace, 3, power=0.05), cfg.samples_per_cycle, as_planes=True
    )
    planar = tuple(scene[..., i].reshape(-1, n).contiguous() for i in (0, 1))
    torch.cuda.synchronize()
    fused_sense_ct.launches = 0
    t0 = time.perf_counter()
    res, freqs = sense_classify_trace(planar, params, 833e6, cfg)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = fused_sense_ct.launches
    if launches < 1:
        raise AssertionError("the main path did not launch the fused_sense_ct kernel")
    dec = res["decision"].cpu().numpy()
    for key, shape in (("avg_spectrum", (CYCLES, n)), ("features", (CYCLES, 4)),
                       ("outputs", (CYCLES, 3)), ("decision", (CYCLES,))):
        v = res[key]
        if tuple(v.shape) != shape or not torch.isfinite(v.float()).all():
            raise AssertionError(f"{key}: shape {tuple(v.shape)} or non-finite values")
    hit = float(np.mean(dec == trace.cpu().numpy() + 1))
    if hit < 0.99:
        raise AssertionError(f"decision == PU channel + 1 on only {hit:.4f} of cycles")
    retune = {1: 835e6, 2: 833e6, 3: 835e6}
    want, f = [], 833e6
    for d in dec:
        f = retune.get(int(d), f)
        want.append(f)
    if not np.array_equal(freqs.cpu().numpy(), np.asarray(want, np.float32)):
        raise AssertionError("tx trace breaks the 1->835, 2->833, 3->835 MHz policy")
    phase("main-path", f"{CYCLES} cycles ({CYCLES * cfg.samples_per_cycle / 1e6:.1f} MSamples) "
          f"in {main_s * 1e3:.1f} ms host time; kernel launches {launches}; decision == PU+1 on "
          f"{hit:.4f}; tx trace follows policy (final {want[-1] / 1e6:.0f} MHz)")

    # 5. the CLI at its default dispatch size
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    cap, out = work / "capture.iq", work / "out.npz"
    try:
        with IQWriter(cap, cfg.sample_rate_hz, cfg.center_hz) as w:
            w.write(scene.reshape(-1, 2).cpu().numpy())
        del scene, planar
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "cognitive_radio_network_tpu_torch", "sense", str(cap),
             "-o", str(out), "-c", str(CLI_CYCLES)],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
        )
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"sense CLI exited {proc.returncode}:\n{proc.stdout}{proc.stderr}")
        with np.load(out) as d:
            cli_dec = d["decision"]
        if cli_dec.shape != (CYCLES,) or not np.array_equal(cli_dec, dec):
            raise AssertionError(f"CLI decisions {cli_dec.shape} differ from the main path's")
        phase("cli", f"{len(cli_dec)} decisions, equal to the main path's, in {cli_s:.1f} s "
              f"(process included): {proc.stdout.strip().splitlines()[0]}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 6. times
    times = {}
    for c in (CYCLES, CLI_CYCLES):
        bufs = max(1, -(-64 * 2**20 // (c * a * n * 8)))  # > 50 MB L2 in all
        inputs = [planes(c) for _ in range(bufs)]

        def kern(xr, xi):
            return fused_sense_ct(xr, xi, averaging=a)

        def plain(xr, xi):
            return fused_sense_ct_plain(xr, xi, averaging=a)

        # in turns: plain, kernel, kernel, plain
        plain_1 = time_ms(plain, inputs)
        kern_1 = time_ms(kern, inputs)
        kern_2 = time_ms(kern, inputs)
        plain_2 = time_ms(plain, inputs)
        k_ms, p_ms = statistics.median(kern_1), statistics.median(plain_1)
        times[c] = (k_ms, p_ms)
        msps = c * a * n / 1e3
        phase("time", f"C={c} f32 ({bufs} input sets): kernel {k_ms:.4f} ms/dispatch "
              f"({msps / k_ms:.0f} MS/s), plain {p_ms:.4f} ms/dispatch ({msps / p_ms:.0f} MS/s), "
              f"median of 3; second turn kernel {statistics.median(kern_2):.4f}, plain "
              f"{statistics.median(plain_2):.4f}; {smi}")
        del inputs

    kernels = [{
        "name": "fused_sense_ct",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": times[CYCLES][0],
        "plain_ms": times[CYCLES][1],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
