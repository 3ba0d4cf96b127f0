#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: build, check, drive, time.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card.  Each phase prints
one line; any failure raises, and the exit code is then non-zero.

1. device and build: the card's name and power limit; builds the kernels of
   ``cognitive_radio_network_tpu_torch/csrc`` into ``build/kernels`` and the
   native runtime library (``native/src``, g++) into ``build/native``, which
   must load.
2. kernel vs plain: ``fused_sense_ct`` against ``fused_sense_ct_plain`` on
   the same card (TF32 off) at C=4096 and C=5 cycles (f32 input), at the
   predictive engine's C=1 on two views of one (2, 10, 512) upload, and with
   bf16 input at ``precision="default"``; the classify form
   (``fused_sense_classify``, the reference weights, log1p features and a
   seeded 4-7-3 network) at the same shapes: spectrum and features
   ``torch.equal`` to ``fused_sense_ct``'s, outputs within atol 1e-5 of the
   plain MLP on its own features and atol 2e-3 (the golden gate's) of
   ``fused_sense_classify_plain``, decisions equal to the rule on its
   outputs; the trace kernel (``sense_trace``) ``torch.equal`` to its plain
   version on random decisions at C=4096.
3. golden gate: 16 cycles of a synthesized PU scene through
   ``make_sense_fn(SenseConfig())`` (one classify launch), held to
   ``tests/golden_reference.py``.
4. main path: a Markov PU trace drives ``synthesize_scene`` and
   ``sense_classify_trace`` over 4096 cycles in one dispatch: exactly one
   classify launch and one trace launch; decisions and the trace
   ``torch.equal`` to ``fused_sense_classify_plain``'s on the card, outputs
   within its atol 2e-3; decisions must track the PU channel and the tx trace
   must follow the retune policy.
5. CLI: a 4096-cycle capture through ``python -m
   cognitive_radio_network_tpu_torch sense`` at 256 cycles per dispatch,
   ingested by the native prefetcher.
6. times: median of 3 for the kernel and the plain version at C=4096 and
   C=256, with CUDA events, and for the kernel on bf16 input at C=4096; GB/s
   read and the share of 3.35 TB/s beside each bound; at C=4096, f32 and
   bf16, the classify form beside ``fused_sense_ct`` in turns (ct, classify,
   classify, ct) by CUDA events and on the card (the profiler's durations
   over 10 alternations of 10 launches: ``profile_sense.measure_kernels``),
   its plain version; the trace kernel and its plain version at C=4096; the
   wrappers' host time at C=1.
7. extract, kernel vs plain: ``extract_window_sets`` against
   ``extract_window_sets_plain`` (``torch.equal``, into its own windows and
   into the caller's, ``out=``) on the OFDM link's block of N=1,265,664
   samples at K=256 windows of 4864 (frames) and 160 (timing refinement)
   samples, with clipped offsets; at N < wlen; at an odd wlen and unaligned
   offsets; the stream step's three lengths in one launch on planes 4 bytes
   past 16-byte alignment (``rr[1:]``) at offsets of every residue mod 4;
   N below one set's wlen; K=0; a wlen of 0 beside another set.
8. the OFDM link at full size: 256 default-config frames (qam4/crc32/h128,
   256-byte payloads, 80-sample gaps) assembled on the card into one block
   and decoded by one ``rx_block_fn(k=256)`` call: 256/256 frames intact,
   the extract kernel launched, and the same result as the CPU run of the
   plain path; then ``receive_block`` on two 16-frame bursts as ``assemble``
   returns them on the card (qam16/none as complex64; v27/v27 with 64-byte
   payloads as (N, 2) planes).
9. times: the host time of the extract wrapper's launch path (a host clock,
   the least of 10 runs of 300 calls: its checks, its allocation, the whole
   call with and without ``out=``, one set and the stream step's three), then
   for the link's frame gather (at its frame starts) and at both link shapes:
   the kernel's time on the card per launch (``torch.profiler``), GB/s and
   the share of 3.35 TB/s against the bound (each output byte written and
   each distinct input sample read once), median of 3 by CUDA events for the
   kernel and its plain version; and one ``rx_block_fn(k=256)`` call (MS/s,
   frames/s).
10. wideband, kernel vs plain: ``wideband_energy_fused`` against
   ``wideband_energy_fused_plain`` (rtol 1e-5, atol 1e-7) at T=524,288
   per-channel times (4096 sense cycles, 33.5 M wide samples) and at T=1,280
   (10 cycles); with a non-zero ``initial_history`` at T=4,096; a stream cut
   in two with the first half's last rows as the second half's history must
   give the whole stream's bits; and against float64 numpy oracles at T=4,096
   (rtol 2e-3, atol 1e-5); then a batch of 3 streams with a history each, in
   one launch a call: planar, interleaved (``wideband_energy_fused_planes``)
   and complex64 input and each stream launched alone ``torch.equal``, B=1
   equal to the unbatched call, within rtol 1e-5, atol 1e-7 of the plain
   version.
11. the wideband path at full width: a scene of 1e-3 noise plus unit tones at
   a few channel centres, made on the card, through
   ``make_wideband_fn(WidebandConfig())`` at T=524,288: the kernel launched,
   outputs finite and of the right shape, ``occupied`` true on exactly the
   active channels in every cycle after the first; then ``wideband_features``
   and the one-device ``make_sharded_apply`` with a seeded 4-5-1 network on a
   (4, T*64, 2) batch at T=65,536: one kernel launch for the batch, and the
   batch's energy held to the packed plain path (``use_fused=False``).
12. features-only sense, kernel vs plain: ``fused_band_features`` against
   ``fused_band_features_plain`` (the dense four-matmul form, rtol 1e-4) and
   against ``fused_sense_ct``'s features (rtol 1e-6: the same register FFT in
   another kernel) at C=4096 and C=5, and equal from run to run; then the
   function once on phase 4's scene, its features through the MLP and the
   decision rule: decisions must track the PU channel as the main path's do.
13. times: median of 3, plain and kernel in turns, for the wideband kernel and
   its plain version at T=524,288, for one ``make_wideband_fn`` call (CUDA
   events back to back; host clock per synchronized call; device operations,
   busy time and idle share from a profiler trace), for the batch of streams
   through the kernel and through the packed path, and for the features-only
   sense kernel and its plain version at C=4096 (beside the 2.6950 ms its
   dense-product predecessor took on this card at 700 W); the wideband
   kernel alone (``profile_wideband.measure``) at T=131,072, 262,144 and
   524,288 and on the (4, 65,536) batch, planar and interleaved: the
   profiler's time on the card, CUDA events, the bound and its share,
   ``torch.sum`` over the same planes, and the fit's fixed us a launch and
   marginal TB/s; ``make_wideband_fn`` on interleaved (T*64, 2) planes and
   on the batch: no copy kernel and as many device operations as the planar
   call.
14. resolve, kernel vs plain: ``resolve_candidates`` against
   ``resolve_candidates_plain`` (``torch.equal``) on random candidate tables
   and on the full-width stream's K=520 columns; then times: the kernel and
   the plain version (a device-to-host round trip and a host loop).
15. the adaptive gate (port of tests/tpu_gates.py::gate_adaptive_stream): two
   configs (qam4/h128 64 bytes, qam16/none 48 bytes) in a 16,000-sample
   stream, blocks of 2,048 with straddlers, through
   ``StreamReceiver(cfg).process_device``: every placed frame within 2
   samples, payloads equal.
16. the three APIs (``process``, ``process_device``, ``feed_device``/``flush``)
   on one random mixed-config stream: equal offsets, headers, payloads, and
   equal to the CPU run; then a qam16/v27 stream through ``process_device``;
   then ``predictive_model.cfg``'s link (qam16, crc32, v27+v27) beside
   qam4/h128 through ``process``, the counts at 0 just before it: all frames
   intact, the Viterbi kernel (``viterbi_decode_k7``) decoding both codes of
   each v27+v27 frame, 2 launches per decoded group of frames, and no host
   step of the plain loop (``fec.viterbi_host_steps``).
17. the adaptive stream at full width (the reference bench's shape,
   bench.py:324-374): 2,048 frames of 256 bytes alternating qam4/h128 and
   qam16/none, gap 512, 4 blocks, ``max_frames_per_block`` 520,
   ``fetch_group`` 8, ``feed_device(max_lag=18)`` + ``flush``: 2,048 frames,
   payloads equal to those sent, mods alternating, all valid, exactly 2
   extract launches (the refinement windows; the header windows and both
   speculated configs' frame windows in one) and 1 resolve launch per step;
   ``extract_window_sets`` against its plain version (``torch.equal``) on a
   step's own buffer and K=520 candidates at the step's two launches, and
   with candidates within 4864 of the buffer's end (each set clipped alone),
   then each launch's time on the card (profiler), by CUDA events, the
   wrapper's host time with ``out=`` and the bound; then
   times: MS/s and frames/s over 6 passes (median of 3), host ms per
   ``feed_device`` call, synchronizing calls inside the dispatches (PyTorch's sync debug mode;
   must be none), device operations, kernel launches and busy time per step
   from a profiler trace, and the device's idle share of a pass.
17b. Viterbi, kernel vs plain: ``viterbi_decode_k7`` against
   ``viterbi_decode_plain`` (``torch.equal``) on encoded random payloads with
   about 4% of the coded bits flipped, at a 256-byte packet's inner code
   (4,176 bits) and outer code (2,080 bits), 1 and 8 frames a launch, the
   plain loop on the card; and one frame of 40,000 bits, the plain loop on
   the CPU; then times: the kernel on the card (profiler, median of 20), by
   CUDA events, the wrapper's host time, the cycles a trellis step, the bound
   and the plain loop's time at one frame.
18. the two-node FDD link scenario (tests/test_runtime.py:117-145: 4 MS/s
   medium, 16,384-sample blocks, 200 kb/s each way) through
   ``ScenarioRuntime`` on the card for 1.0 s: packets both ways with payloads
   equal to the m-sequence, the extract kernel launched, no failed node; the
   host time per step by runtime layer; the summary of a 0.25 s run equal to
   the CPU run's.
19. ``scenarios/eight_node.cfg`` at its shipped widths (three FDD pairs, a
   gated CW and a sweeping noise interferer, 16 MS/s, 65,536-sample blocks,
   ``rx_scan_blocks`` 4) for 2.0 s: every radio receives intact packets, no
   failed node; wall time, realtime factor and host time per layer.  In each
   of 18-20, a profiler trace of a few dozen steps of a fresh run gives the
   device operations and busy time per step and the device's idle share.
20. ``scenarios/predictive_model.cfg`` as the reference's bench runs it
   (bench.py:452-467): a 0.5 s warm-up, then 12.0 s: no failed node,
   decisions, exactly one ``fused_sense_ct`` launch per decision, the
   Viterbi kernel's launches, and
   ``scenario_realtime_factor`` = steady_t / steady_wall_time_s; then the
   ``CE_TX_CHANNEL_X -c 1`` variant (the SU decides 1 and retunes to 835 MHz;
   its decisions equal the CPU run's, its MLP outputs within atol 2e-3);
   a profiler trace of one classify call, and of the sense path at C=4096,
   C=256 and C=1 with and without the trace (device operations, busy time,
   the sense kernels' share, idle share): a ``make_sense_fn`` call on planes
   and parameters on the card must make 1 device operation, 2 with the
   trace.
21. the two-node link of phase 18 distributed (``NetController(...,
   device="cuda", transport="native")``: a controller here, one node process
   per node on the card) for 0.25 s: the summary equal to phase 18's
   in-process one, each node reporting ``extract_windows`` launches.
22. ``scenarios/eight_node.cfg -d`` for 2.0 s (the reference bench's 16.0 s,
   bench.py:516, cut to phase 19's length): eight node processes on one
   card; the summary equal to phase 19's, bytes received by every radio, a
   summary from every node; the realtime factor of the steady window, the
   per-node CPU margin (``max_node_cpu_per_sim_s``), CPU ms per step of each
   node, extract launches per node and the wall time.
23. ``scenarios/predictive_model.cfg -d``: a 2.0 s warm run, then 12.0 s (the
   reference bench's 40.0 s, bench.py:478-488, cut): the SU's node reports
   ``fused_sense_ct`` launches; the distributed realtime factor.
24. training at the reference's own settings (tests/test_scenarios.py:186-231):
   ``make_dataset(400, signal_power=0.005, power_jitter_decades=2.5)`` makes
   exactly one ``fused_sense_ct`` launch; ``fit`` runs 3000 steps with no
   synchronizing call inside its loop (PyTorch's sync debug mode: the one
   readback of the losses after the loop is all) and the loss falls; the
   trained net and the reference weights score a held-out 256-cycle Markov
   trace at five powers through ``make_sense_fn`` (generator seeds 0, 1, 42 and
   8, fixed): trained >= reference at every power, and at 1e-4 trained >= 0.95
   and reference <= 0.9; times of ``make_dataset`` and ``fit``
   (``utils/profiling.py::device_time``), device operations and busy time of a
   step.
25. the wideband train step at full width: ``WidebandConfig()`` on phase 11's
   batch shape (4 streams of T=65,536, tones at random channels made on the
   card), 150 steps at lr 3e-2 (tests/test_distributed_training.py:22-39):
   exactly 1 ``wideband_energy_fused`` launch in every step, the first
   step's loss within rtol 1e-5 of the loss over the packed plain path's
   energies, the loss halves and ends below 0.2, ``make_sharded_apply``
   accuracy above 0.95; ms per step and the kernel's share of busy time.
26. the surface: ``python -m cognitive_radio_network_tpu_torch train`` in a
   process on the card, its checkpoint read by ``load_mlp_with_meta``; the
   ``spectrum`` command on a capture of a PU on CH2 made on the card (the peak
   within CH2's band); ``gmsk_frame`` on the card within atol 1e-6 of the CPU.

27. the multi-device layer on the card, N ranks in N processes sharing it
   through ``gloo`` (NCCL takes one card per rank): the fused sharded wideband
   energy (``sharded_wideband_energy_fused``, kernel 3 per rank seeded with the
   left neighbour's last 4 pair rows) at T=524,288 over time=2 and time=4,
   ``torch.equal`` to kernel 3 on the whole stream, one launch per rank, and
   ``make_wideband_fn(cfg, mesh=)`` alike; ms per call by CUDA events back to
   back and by the host clock, ranks side by side.
28. over time=2: ``ShardedFrameReceiver`` on phase 8's link block (256/256
   frames, byte-equal to ``receive_block(k=256)`` on one device) and
   ``ShardedStreamReceiver.receive_device`` on phase 17's adaptive stream
   (2,048/2,048 frames byte-equal to ``StreamReceiver.process``, no sample
   copied from the host); extract launches per rank; host time.
29. the sharded wideband train step at phase 25's width, 20 steps on
   (data=2) and on (time=2), from ``init_fn``'s broadcast parameters, losses
   within rtol 1e-5 of the one-device step's from the same parameters; the
   same on a world of one over NCCL; kernel 3 launches once per step per rank.
30. ``graft_entry.dryrun_multichip(n)`` for n = 2 and 4 (gloo), which holds
   its sharded loss and frames to one device's.

The line before the last is a JSON object with each kernel's launches on its
path (kernels 1 and 3 also on the training paths, kernels 2 and 3 on the
sharded paths of phases 27-29 as ``sharded_launches``), error, times and bound (the least time the card could take: bytes moved
over 3.35 TB/s or the float32 operations the function needs, with an FFT for
a DFT, over 67 TFLOP/s, whichever is larger); the wideband entry also has
the (4, 65,536) batch's ``batch_ms`` and ``batch_bound_ms``; the sense
entry the classify form's ``tail_ms`` (f32 and bf16, C=4096) and
``tail_max_abs_err``, and ``path_calls``: device operations and ms of a
``make_sense_fn`` call at C = 4096, 256 and 1, with and without the trace;
the trace kernel has an entry of its own (``sense_trace``); the Viterbi
kernel's entry (``viterbi_decode_k7``) its launches, ``process`` calls and
kernel frames in phase 16's v27+v27 stream, its launches in phase 20, and
each shape of phase 17b (the bound there counts the selectors' round trip
through the scratch too; the kernel is bound by the latency of its dependent
trellis steps, far above it).
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "cognitive_radio_network_tpu_torch/csrc/fused_sense_ct.cu"
KERNEL_REPLACES = "cognitive_radio_network_tpu/ops/fused_sense_ct.py:51"
# no TPU kernel: the lax.scan of the reference's sense_classify_trace
TRACE_REPLACES = "cognitive_radio_network_tpu/models/sense.py:158"
EXTRACT_SOURCE = "cognitive_radio_network_tpu_torch/csrc/extract_windows.cu"
EXTRACT_REPLACES = "cognitive_radio_network_tpu/ops/extract.py:46"
CYCLES = 4096  # cycles per dispatch of the reference's bench (bench.py:132)
CLI_CYCLES = 256  # the sense CLI's default cycles per dispatch
LINK_FRAMES = 256  # frames per rx block of the reference's gate (tests/tpu_gates.py:137)
LINK_GAP = 80  # samples between frames (tests/tpu_gates.py:138)
LINK_PAYLOAD = 256  # reference packet size (include/crts.hpp:192-194)
WIDE_SOURCE = "cognitive_radio_network_tpu_torch/csrc/fused_wideband.cu"
WIDE_REPLACES = "cognitive_radio_network_tpu/ops/fused_wideband.py:91"
DENSE_SOURCE = "cognitive_radio_network_tpu_torch/csrc/fused_sense.cu"
DENSE_REPLACES = "cognitive_radio_network_tpu/ops/fused_sense.py:35"
DENSE_PRODUCT_MS = 2.6950  # the kernel as a tiled dense product, C=4096, H100 80GB HBM3 at 700 W
RESOLVE_SOURCE = "cognitive_radio_network_tpu_torch/csrc/resolve_candidates.cu"
# no TPU kernel: the lax.scan of the reference's stream-step graph
RESOLVE_REPLACES = "cognitive_radio_network_tpu/phy/framesync.py:900"
VITERBI_SOURCE = "cognitive_radio_network_tpu_torch/csrc/viterbi_k7.cu"
# no TPU kernel: the lax.scan of the reference's v27 decoder
VITERBI_REPLACES = "cognitive_radio_network_tpu/phy/fec.py:263"
# (decoded bits, frames a launch): a 256-byte crc32 packet's inner code (4,176
# bits, 4,182 steps) and outer code (2,080 bits), alone and 8 at once; and one
# frame of 40,006 steps, 20 of the kernel's 2,048-step chunks
VITERBI_SHAPES = ((4176, 1), (4176, 8), (2080, 1), (2080, 8), (40_000, 1))
STREAM_FRAMES, STREAM_PAYLOAD, STREAM_GAP = 2048, 256, 512  # bench.py:326-338
STREAM_BLOCKS, STREAM_LAG, STREAM_GROUP, STREAM_PASSES = 4, 18, 8, 6  # bench.py:355-357, :390
WIDE_T = 524_288  # per-channel times per dispatch of the reference's bench (bench.py:250-261)
WIDE_ACTIVE = (3, 17, 40, 63)  # channels that carry a tone in the wide scene
APPLY_BATCH, APPLY_T = 4, 65_536  # the batch of streams of the apply step
LINK_SCN_S = 1.0  # sim seconds of the two-node link scenario
EIGHT_NODE_S = 2.0  # sim seconds of scenarios/eight_node.cfg (bench.py:512-513)
PREDICTIVE_S = 12.0  # sim seconds of scenarios/predictive_model.cfg (bench.py:458)
DIST_EIGHT_NODE_S = 2.0  # the reference bench runs 16.0 (bench.py:516); cut to phase 19's length
DIST_PREDICTIVE_WARM_S, DIST_PREDICTIVE_S = 2.0, 12.0  # bench.py:478-488 runs 2.0, then 40.0
DIST_PORT = 47760  # TCP ports 47760-47763 of the distributed phases
TRAIN_EXAMPLES, TRAIN_STEPS = 400, 3000  # tests/test_scenarios.py:186-190
WIDE_TRAIN_STEPS = 150  # tests/test_distributed_training.py:29
WIDE_COMPARED_STEPS = 20  # sharded vs one-device train steps of phase 29
# candidates per shard of the sharded stream: a 2-way split of a block of the
# adaptive stream puts about 263 frame starts in the first shard's 2**20 samples
SHARD_STREAM_K = 320
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate
FP32_FLOPS = 67e12  # H100 SXM float32 rate outside the tensor cores


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    """The least time in ms the card could take: every input byte read once
    and every output byte written once at the memory rate, or the float32
    operations at the FP32 pipes' peak, whichever is larger."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def sense_bound(cycles: int, averaging: int, n: int, itemsize: int) -> tuple[float, str]:
    """The bound of the sense function: both planes read once, the spectrum and
    the features written once, the twiddle and band tables read once; per
    sample the 9 radix-2 stages of an FFT (5 flops each) and the magnitude."""
    samples = cycles * averaging * n
    return bound(samples * 2 * itemsize + cycles * (n + 4) * 4 + n * 8 + n * 16, samples * 50)


def kernel_of(ptxas_line: str) -> str:
    """The kernel a ptxas "Compiling entry function" line names, with its
    template arguments as mangled (a mangled name holds each identifier after
    its length)."""
    symbol = ptxas_line.split("'")[1] if "'" in ptxas_line else ptxas_line
    for m in re.finditer(r"\d+", symbol):
        for start in range(m.start(), m.end()):  # the digits may follow a hash's digits
            name = symbol[m.end() : m.end() + int(symbol[start : m.end()])]
            if name.endswith("_kernel"):
                args = re.match(r"I(\w+?)EE", symbol[m.end() + len(name) :])
                return f"{name}<{args.group(1)}>" if args else name
    return symbol


def reset_counts() -> None:
    """Every kernel's launch count to 0, right before a path is driven."""
    from cognitive_radio_network_tpu_torch import ops

    for fn in (ops.fused_sense_ct, ops.extract_windows, ops.wideband_energy_fused,
               ops.fused_band_features, ops.resolve_candidates, ops.sense_trace,
               ops.viterbi_decode_k7):
        fn.launches = 0


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


def host_us(fn, calls: int = 300, runs: int = 10) -> float:
    """Host time per call in us: the least of ``runs`` runs of ``calls`` calls
    by the host clock, the device drained between runs and not inside them
    (runs short enough that the launch queue never fills, many enough that
    the least is one the host's neighbours left alone)."""
    import torch

    for _ in range(50):
        fn()
    best = float("inf")
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return best


def traced(body, label: str, what: str) -> tuple[dict, float, float, int]:
    """Run ``body()`` under the profiler (host and card), export the Chrome
    trace under build/, read it back and remove it.  ``body`` opens
    ``record_function(label)`` spans; returns the trace and those spans' host
    us, device busy us and device operations.  Raises if the spans launched
    no device operation."""
    import torch

    from cognitive_radio_network_tpu_torch.profile_link import stage_device_times

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        body()
        torch.cuda.synchronize()
    path = ROOT / "build" / f"chip_smoke_{label}_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    finally:
        path.unlink(missing_ok=True)
    _, host_us, busy_us, ops = stage_device_times(trace, [label])[label]
    if ops == 0:
        raise AssertionError(f"the trace holds no device operation launched by {what}")
    return trace, host_us, busy_us, ops


def short_name(kernel: str) -> str:
    """A kernel's name without its return type, namespaces and arguments."""
    name = kernel.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0].split("<")[0].split("::")[-1]


def span_kernels(trace: dict, label: str) -> list[list[str]]:
    """For each ``record_function(label)`` span of a Chrome trace, the names
    of the device operations it launched (same correlation id, the launch on
    the span's thread inside it), in launch order."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    device = {e["args"]["correlation"]: e["name"] for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and "correlation" in e.get("args", {})}
    launches = sorted((float(e["ts"]), e["pid"], e["tid"], e["args"]["correlation"]) for e in events
                      if e.get("cat") in ("cuda_runtime", "cuda_driver")
                      and e.get("args", {}).get("correlation") in device)
    out = []
    for span in events:
        if span.get("cat") != "user_annotation" or span.get("name") != label:
            continue
        t0, t1 = float(span["ts"]), float(span["ts"]) + float(span["dur"])
        out.append([device[c] for ts, pid, tid, c in launches
                    if t0 <= ts <= t1 and (pid, tid) == (span["pid"], span["tid"])])
    return out


def launch_path_table(rr, ri, offs, smi: str) -> None:
    """Where the extract wrapper's host time goes: the input checks and the
    output allocation alone, then the whole call, whose remainder is the
    ctypes call with the launch in it, without ``out=`` and with the caller's
    windows.  The other three wrappers share the path."""
    import torch

    from cognitive_radio_network_tpu_torch.ops._launch import input_ptr
    from cognitive_radio_network_tpu_torch.ops.extract import (
        extract_window_sets,
        extract_windows,
        window_buffers,
    )

    dev, k, wlen = rr.device, offs.shape[0], 4864
    offs32 = offs.to(torch.int32)
    step = (688, 4864, 2080)  # the stream step's sets
    win = window_buffers(rr, k, (wlen,))[0]
    wins = window_buffers(rr, k, step)
    rows = [
        ("three input_ptr checks", lambda: [
            input_ptr(rr, "rr", dev), input_ptr(ri, "ri", dev), input_ptr(offs, "offsets", dev)]),
        ("window_buffers(rr, K, (wlen,)): the one allocation", lambda: window_buffers(rr, k, (wlen,))),
        ("whole wrapper, int64 offsets, wlen=4864", lambda: extract_windows(rr, ri, offs, 4864)),
        ("whole wrapper, int32 offsets, wlen=4864", lambda: extract_windows(rr, ri, offs32, 4864)),
        ("whole wrapper, int64 offsets, wlen=160", lambda: extract_windows(rr, ri, offs, 160)),
        ("whole wrapper with out=, int64 offsets, wlen=4864",
         lambda: extract_windows(rr, ri, offs, 4864, out=win)),
        ("extract_window_sets, wlens 688+4864+2080", lambda: extract_window_sets(rr, ri, offs, step)),
        ("extract_window_sets with out=, wlens 688+4864+2080",
         lambda: extract_window_sets(rr, ri, offs, step, out=wins)),
        ("for scale: one small PyTorch operator, rr[:1024] + 1", lambda: rr[:1024] + 1),
    ]
    for label, fn in rows:
        phase("launch-path", f"{label}: {host_us(fn):.3f} us host time per call")
    phase("launch-path", f"least of 10 runs of 300 calls each, by the host clock; {smi}")


def link_block(dev, rng):
    """The OFDM link's block (phase 8): ``LINK_FRAMES`` default-config frames of
    ``LINK_PAYLOAD`` bytes assembled on the card, each followed by ``LINK_GAP``
    zeros, as planes; headers and payloads drawn from ``rng``.  Returns (re,
    im, headers, payloads, the (F, flen, 2) frames)."""
    import numpy as np
    import torch

    from cognitive_radio_network_tpu_torch.phy import OFDMFrameConfig, OFDMFrameGen

    gen = OFDMFrameGen(OFDMFrameConfig(), LINK_PAYLOAD)
    hdrs = rng.integers(0, 256, (LINK_FRAMES, 8)).astype(np.uint8)
    pays = rng.integers(0, 256, (LINK_FRAMES, LINK_PAYLOAD)).astype(np.uint8)
    frames = gen.assemble(hdrs, pays, as_planes=True, device=dev)  # (F, flen, 2)
    gap = torch.zeros((LINK_FRAMES, LINK_GAP, 2), device=dev)
    block = torch.cat([frames, gap], dim=1).reshape(-1, 2)
    return block[:, 0].contiguous(), block[:, 1].contiguous(), hdrs, pays, frames


def link_phases(dev, smi: str) -> dict:
    """Phases 7-9: the extract kernel against its plain version, the OFDM link
    at full size, and their times.  Returns the kernel's entry of the kernels
    line."""
    import numpy as np
    import torch

    from cognitive_radio_network_tpu_torch.ops.extract import (
        extract_window_sets,
        extract_window_sets_plain,
        extract_windows,
        extract_windows_plain,
    )
    from cognitive_radio_network_tpu_torch.phy import OFDMFrameConfig, OFDMFrameGen, OFDMFrameSync
    from cognitive_radio_network_tpu_torch.profile_extract import device_us_per_launch, gather_bytes

    cfg = OFDMFrameConfig()  # ECR defaults: 32 subcarriers, cp 16, qam4/crc32/h128/none
    gen = OFDMFrameGen(cfg, LINK_PAYLOAD)
    flen = gen.frame_len
    n_link = LINK_FRAMES * (flen + LINK_GAP)

    # 7. extract, kernel vs plain on the card
    g = torch.Generator(device=dev).manual_seed(11)
    rr = torch.randn(n_link, generator=g, device=dev)
    ri = torch.randn(n_link, generator=g, device=dev)

    def offsets(k: int, n: int, wlen: int, odd: bool = False):
        hi = max(n - wlen, 0)
        if odd:
            o = 2 * torch.randint(0, hi // 2, (k,), generator=g, device=dev) + 1
        else:
            o = torch.randint(0, hi + 1, (k,), generator=g, device=dev)
        o[:3] = torch.tensor([-7, n - 3, n + 100], device=dev)  # clipped to [0, n - wlen]
        return o

    def residues(k: int, n: int):
        """Offsets of every residue mod 4, the last few within 4864 of the end."""
        o = 4 * torch.randint(0, n // 4, (k,), generator=g, device=dev) + torch.arange(k, device=dev) % 4
        o[-4:] = n - torch.tensor([4864, 3001, 690, 3], device=dev)
        return o

    cases = [
        (f"N={n_link} K=256 wlen=4864", rr, ri, offsets(256, n_link, 4864), (4864,)),
        (f"N={n_link} K=256 wlen=160", rr, ri, offsets(256, n_link, 160), (160,)),
        ("N=100 < wlen=160 K=4", rr[:100], ri[:100],
         torch.tensor([0, 5, -3, 200], device=dev), (160,)),
        (f"N={n_link} K=64 odd wlen=333, odd offsets", rr, ri,
         offsets(64, n_link, 333, odd=True), (333,)),
        (f"N={n_link - 1} K=256 wlens 688+4864+2080 in one launch, planes 4 bytes past 16-byte "
         "alignment (rr[1:]), offsets of every residue mod 4", rr[1:], ri[1:],
         residues(256, n_link - 1), (688, 4864, 2080)),
        ("N=3000 K=8 wlens 160+4864 (N < the second's wlen)", rr[:3000], ri[:3000],
         offsets(8, 3000, 160), (160, 4864)),
        ("K=0 wlens 688+4864", rr, ri, torch.zeros(0, dtype=torch.int64, device=dev), (688, 4864)),
        (f"N={n_link} K=16 wlens 0+688", rr, ri, offsets(16, n_link, 688), (0, 688)),
    ]
    max_abs_err = 0.0
    for label, a, b, o, wlens in cases:
        before = extract_windows.launches
        got = extract_window_sets(a, b, o, wlens)
        launched = extract_windows.launches - before
        want = extract_window_sets_plain(a, b, o, wlens)
        into = extract_window_sets(a, b, o, wlens, out=[tuple(torch.empty_like(x) for x in p)
                                                         for p in want])
        torch.cuda.synchronize()
        if launched != (1 if o.numel() and any(wlens) else 0):
            raise AssertionError(f"extract_window_sets launched {launched} times at {label}")
        err = 0.0
        for (gr, gi), (wr, wi), (ir, ii) in zip(got, want, into):
            if not (torch.equal(gr, wr) and torch.equal(gi, wi) and torch.equal(ir, wr)
                    and torch.equal(ii, wi)):
                raise AssertionError(f"extract kernel differs from the plain version at {label}")
            if gr.numel():
                err = max(err, (gr - wr).abs().max().item(), (gi - wi).abs().max().item())
        max_abs_err = max(max_abs_err, err)
        phase("extract-vs-plain", f"{label}: torch.equal on both planes of every set, into its "
              f"own windows and the caller's (out=), {launched} launch (max abs err {err:.1e})")

    # 8. the OFDM link at full size (port of tests/tpu_gates.py::gate_ofdm_decode)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    lr, li, hdrs, pays, frames = link_block(dev, rng)
    torch.cuda.synchronize()
    asm_s = time.perf_counter() - t0
    torch.testing.assert_close(
        frames[:4].cpu(), gen.assemble(hdrs[:4], pays[:4], as_planes=True, device="cpu"),
        rtol=0, atol=1e-5,
    )
    sync = OFDMFrameSync(cfg, LINK_PAYLOAD)
    rxfn = sync.rx_block_fn(k=LINK_FRAMES)
    nvalid = torch.tensor(n_link, device=dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    bests, peaks, cfos, out, ok = rxfn(lr, li, nvalid)
    torch.cuda.synchronize()
    rx_s = time.perf_counter() - t0
    launches = extract_windows.launches
    if launches < 2:
        raise AssertionError(f"rx_block_fn launched the extract kernel {launches} times, not >= 2")
    n_ok = int(ok.sum())
    order = torch.argsort(bests).cpu()
    want_offs = np.arange(LINK_FRAMES) * (flen + LINK_GAP)
    if n_ok != LINK_FRAMES or not np.array_equal(bests.cpu()[order].numpy(), want_offs):
        raise AssertionError(f"{n_ok}/{LINK_FRAMES} frames ok; offsets differ from the burst's")
    for key, sent in (("headers", hdrs), ("payloads", pays)):
        if not np.array_equal(out[key].cpu()[order].numpy(), sent):
            raise AssertionError(f"decoded {key} differ from what was sent")
    if not bool(out["pay_ok"].all()):
        raise AssertionError("a payload CRC failed")
    for key in ("evm_db", "rssi_db", "cfo"):
        if not bool(torch.isfinite(out[key]).all()):
            raise AssertionError(f"{key} has non-finite values")
    # the same block through the plain path on the CPU
    cb, _, cc, cout, cok = sync.rx_block_fn(k=LINK_FRAMES)(lr.cpu(), li.cpu(), n_link)
    corder = torch.argsort(cb)
    if not (torch.equal(cb[corder], bests.cpu()[order]) and bool(cok.all())):
        raise AssertionError("the CPU run of the plain path found other frames")
    for key in ("headers", "payloads", "hdr_ok", "pay_ok"):
        if not torch.equal(cout[key][corder], out[key].cpu()[order]):
            raise AssertionError(f"{key} differ between the card and the CPU run")
    cfo_err = (cc[corder] - cfos.cpu()[order]).abs().max().item()
    rssi_err = (cout["rssi_db"][corder] - out["rssi_db"].cpu()[order]).abs().max().item()
    if cfo_err > 1e-6 or rssi_err > 1e-3:
        raise AssertionError(f"card vs CPU: cfo err {cfo_err:.2e}, rssi err {rssi_err:.2e} dB")
    phase("link", f"{LINK_FRAMES} frames x {flen} samples + {LINK_GAP} gap = N {n_link} "
          f"assembled on the card in {asm_s:.2f} s; one rx_block_fn(k={LINK_FRAMES}) call: "
          f"{n_ok}/{LINK_FRAMES} ok, headers and payloads equal to those sent, in "
          f"{rx_s * 1e3:.1f} ms host time (first call); extract launches {launches}; vs the "
          f"CPU run: same frames, cfo max err {cfo_err:.1e} (bound 1e-6), rssi {rssi_err:.1e} dB "
          f"(bound 1e-3); evm {out['evm_db'].max().item():.1f} dB at most")
    # receive_block takes the block as assemble gives it: complex, or (N, 2) planes
    for label, kw, payload_len, as_planes in (
        ("qam16/none", {"mod_scheme": "qam16", "fec0": "none"}, LINK_PAYLOAD, False),
        ("qam16 v27/v27", {"mod_scheme": "qam16", "fec0": "v27", "fec1": "v27"}, 64, True),
    ):
        c2 = OFDMFrameConfig(**kw)
        g2 = OFDMFrameGen(c2, payload_len)
        h2 = rng.integers(0, 256, (16, 8)).astype(np.uint8)
        p2 = rng.integers(0, 256, (16, payload_len)).astype(np.uint8)
        f2 = g2.assemble(h2, p2, as_planes=as_planes)
        lead = torch.zeros((16, 137, *f2.shape[2:]), dtype=f2.dtype, device=dev)
        b2 = torch.cat([lead, f2], dim=1).reshape(-1, *f2.shape[2:])
        before = extract_windows.launches
        t0 = time.perf_counter()
        got = OFDMFrameSync(c2, payload_len).receive_block(b2, k=32)
        rb_s = time.perf_counter() - t0
        if extract_windows.launches < before + 2:
            raise AssertionError(f"receive_block {label} did not launch the extract kernel")
        offs = [f["offset"] for f in got]
        if offs != [137 + i * (137 + g2.frame_len) for i in range(16)]:
            raise AssertionError(f"receive_block {label}: frames at {offs}")
        for f, h, p in zip(got, h2, p2):
            if not (np.array_equal(f["header"], h) and np.array_equal(f["payload"], p)
                    and f["stats"].payload_valid):
                raise AssertionError(f"receive_block {label}: a frame did not decode intact")
        form = "(N, 2) float32 planes" if as_planes else "complex64"
        phase("link", f"receive_block {label}, {payload_len}-byte payloads, {form} block from "
              f"assemble on the card: 16/16 frames intact in {rb_s:.2f} s host time (first call)")

    # 9. the wrapper's host time, step by step, then times: in turns plain,
    # kernel, kernel, plain
    launch_path_table(rr, ri, offsets(256, n_link, 4864), smi)
    # the link's frame gather: K=256 frame windows at the block's frame starts
    # (phase 8's offsets), then random offsets at both link shapes
    times = {}
    link_offs = torch.arange(LINK_FRAMES, device=dev) * (flen + LINK_GAP)
    for label, o, wlen in (("frame windows at the link's frame starts", link_offs, flen),
                           ("random offsets", offsets(256, n_link, 4864), 4864),
                           ("random offsets", offsets(256, n_link, 160), 160)):
        inputs = [(rr, ri, o, wlen)]
        plain_1 = time_ms(extract_windows_plain, inputs)
        kern_1 = time_ms(extract_windows, inputs)
        kern_2 = time_ms(extract_windows, inputs)
        plain_2 = time_ms(extract_windows_plain, inputs)
        k_ms, p_ms = statistics.median(kern_1), statistics.median(plain_1)
        win = extract_windows_plain(rr, ri, o, wlen)
        dev_us, _ = device_us_per_launch(lambda: extract_windows(rr, ri, o, wlen, out=win))
        nbytes = gather_bytes(o, n_link, (wlen,))
        b_ms, b_by = bound(nbytes, 0)
        gbs = nbytes / (dev_us * 1e-6) / 1e9
        times[label, wlen] = (k_ms, p_ms, dev_us / 1e3, b_ms, b_by)
        phase("time", f"extract K=256 wlen={wlen} on N={n_link}, {label}: on the card {dev_us:.2f} "
              f"us per launch (profiler: {gbs:.0f} GB/s moved, {gbs / 3350:.1%} of 3.35 TB/s, "
              f"{dev_us / 1e3 / b_ms:.2f}x the bound {b_ms:.4f} ms by {b_by}: {nbytes / 1e6:.1f} MB, "
              f"each output byte written and each distinct input sample read once); per call by "
              f"CUDA events: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, median of 3; second turn "
              f"kernel {statistics.median(kern_2):.4f}, plain {statistics.median(plain_2):.4f}; "
              f"{smi}")
    link_t = time_ms(rxfn, [(lr, li, nvalid)], reps=5)
    link_ms = statistics.median(link_t)
    phase("time", f"OFDM link rx_block_fn(k={LINK_FRAMES}) at N={n_link}: {link_ms:.4f} ms/call "
          f"({n_link / link_ms / 1e3:.1f} MS/s, {LINK_FRAMES / link_ms * 1e3:.0f} frames/s), "
          f"median of 3 runs of 5 calls (runs {', '.join(f'{t:.4f}' for t in link_t)}); {smi}")
    k_ms, p_ms, dev_ms, bound_ms, bound_by = times["frame windows at the link's frame starts", flen]
    return {
        "name": "extract_windows",
        "route": "cuda",
        "source": EXTRACT_SOURCE,
        "replaces": EXTRACT_REPLACES,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "shape": f"N={n_link} K={LINK_FRAMES} wlen={flen}, the link's frame gather",
        "ms": k_ms,
        "device_ms": dev_ms,  # the profiler's kernel time per launch
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call gathers clipped windows of two planes
    }


def wideband_energy_f64(xr, xi, taps, block_len, hist_r=None, hist_i=None):
    """float64 numpy oracle of the wideband energy math, independent of the
    port: depthwise polyphase FIR (rows before the stream from the history's
    8 phase rows, else zero) -> 64-point DFT -> per-cycle mean power."""
    import numpy as np

    p, m = taps.shape
    t = xr.size // m
    pre_r = np.zeros((p, m)) if hist_r is None else hist_r.reshape(p, m).astype(np.float64)
    pre_i = np.zeros((p, m)) if hist_i is None else hist_i.reshape(p, m).astype(np.float64)
    ext_r = np.concatenate([pre_r[1:], xr.reshape(t, m)], axis=0)
    ext_i = np.concatenate([pre_i[1:], xi.reshape(t, m)], axis=0)
    vr, vi = np.zeros((t, m)), np.zeros((t, m))
    for d in range(p):  # v[t] = sum_d taps[d] * x[t - d]
        vr += taps[d].astype(np.float64) * ext_r[p - 1 - d : p - 1 - d + t]
        vi += taps[d].astype(np.float64) * ext_i[p - 1 - d : p - 1 - d + t]
    ang = -2.0 * np.pi * np.outer(np.arange(m), np.arange(m)) / m
    wre, wim = np.cos(ang), np.sin(ang)
    yr, yi = vr @ wre - vi @ wim, vr @ wim + vi @ wre
    return (yr**2 + yi**2).reshape(t // block_len, block_len, m).mean(axis=1)


def wideband_and_dense_phases(dev, smi: str, sense_planar, pu_trace, params) -> list[dict]:
    """Phases 10-13: the wideband kernel against its plain version and the
    float64 oracles, the wideband path at full width, the features-only sense
    kernel against its plain version and on the sense scene, and their times.
    Returns the two kernels' entries of the kernels line."""
    import numpy as np
    import torch

    from cognitive_radio_network_tpu_torch.models import (
        SenseConfig,
        make_sharded_apply,
        wideband_features,
    )
    from cognitive_radio_network_tpu_torch.ops import (
        fused_band_features,
        fused_band_features_plain,
        fused_sense_ct,
        wideband_energy_fused,
        wideband_energy_fused_plain,
        wideband_energy_fused_planes,
        wideband_energy_fused_planes_plain,
    )
    from cognitive_radio_network_tpu_torch.parallel import WidebandConfig, make_wideband_fn
    from cognitive_radio_network_tpu_torch.profile_wideband import measure
    from cognitive_radio_network_tpu_torch.profile_wideband import wide_bound as wide_bound_fn
    from cognitive_radio_network_tpu_torch.signal.detector import occupancy_decision
    from cognitive_radio_network_tpu_torch.signal.mlp import OccupancyMLP

    wcfg = WidebandConfig()
    m, bl = wcfg.num_channels, wcfg.block_len
    taps_np = wcfg.taps()
    taps = torch.from_numpy(taps_np).to(dev)
    g = torch.Generator(device=dev).manual_seed(21)

    def wide(t: int):
        return (torch.randn(t * m, generator=g, device=dev),
                torch.randn(t * m, generator=g, device=dev))

    # 10. wideband, kernel vs plain on the card
    wide_err = 0.0
    big = wide(WIDE_T)
    for label, (xr, xi) in ((f"T={WIDE_T}", big), ("T=1280", wide(1280))):
        got = wideband_energy_fused(xr, xi, taps, wcfg, precision="highest")
        want = wideband_energy_fused_plain(xr, xi, taps, wcfg, precision="highest")
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
        err = (got - want).abs().max().item()
        wide_err = max(wide_err, err)
        rel = ((got - want).abs() / want.abs()).max().item()
        phase("wideband-vs-plain", f"{label} (C={got.shape[0]}): max abs err {err:.3e}, max rel "
              f"err {rel:.3e} (rtol 1e-5, atol 1e-7)")
    xr, xi = wide(4096)
    hist = tuple(h.reshape(4, 2 * m) for h in wide(8))
    got_h = wideband_energy_fused(xr, xi, taps, wcfg, initial_history=hist)
    want_h = wideband_energy_fused_plain(xr, xi, taps, wcfg, precision="highest",
                                         initial_history=hist)
    torch.testing.assert_close(got_h, want_h, rtol=1e-5, atol=1e-7)
    rest = wideband_energy_fused(xr, xi, taps, wcfg)
    if torch.equal(got_h[0], rest[0]) or not torch.equal(got_h[1:], rest[1:]):
        raise AssertionError("initial_history must change cycle 0 and nothing else")
    half = 2048 * m
    first = wideband_energy_fused(xr[:half], xi[:half], taps, wcfg)
    carry = (xr[half - 8 * m : half].reshape(4, 2 * m), xi[half - 8 * m : half].reshape(4, 2 * m))
    second = wideband_energy_fused(xr[half:], xi[half:], taps, wcfg, initial_history=carry)
    if not torch.equal(torch.cat([first, second]), rest):
        raise AssertionError("a stream cut in two with the history carried differs from the whole")
    xr_np, xi_np = xr.cpu().numpy(), xi.cpu().numpy()
    hist_np = [h.cpu().numpy() for h in hist]
    np.testing.assert_allclose(rest.cpu().numpy(), wideband_energy_f64(xr_np, xi_np, taps_np, bl),
                               rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(got_h.cpu().numpy(),
                               wideband_energy_f64(xr_np, xi_np, taps_np, bl, *hist_np),
                               rtol=2e-3, atol=1e-5)
    o_rel = np.abs(rest.cpu().numpy() / wideband_energy_f64(xr_np, xi_np, taps_np, bl) - 1).max()
    phase("wideband-vs-plain", "T=4096: with initial_history within rtol 1e-5, atol 1e-7 of the "
          "plain version; the stream cut in two with the history carried equals the whole "
          f"(torch.equal); float64 oracles with and without history within rtol 2e-3, atol 1e-5 "
          f"(max rel err {o_rel:.3e})")
    del xr, xi, got_h, want_h, rest, first, second
    # the batch and interleaved forms: one launch for a batch of streams, each
    # with its own history, the same bits as each stream launched alone and
    # as the planar form on the same samples
    bplanes = torch.randn(3, 4096 * m, 2, generator=g, device=dev)
    bhist = tuple(torch.randn(3, 4, 2 * m, generator=g, device=dev) for _ in range(2))
    bxr, bxi = bplanes[..., 0].contiguous(), bplanes[..., 1].contiguous()
    before = wideband_energy_fused.launches
    b_planar = wideband_energy_fused(bxr, bxi, taps, wcfg, initial_history=bhist)
    b_planes = wideband_energy_fused_planes(bplanes, taps, wcfg, initial_history=bhist)
    b_complex = wideband_energy_fused_planes(torch.view_as_complex(bplanes), taps, wcfg,
                                             initial_history=bhist)
    if wideband_energy_fused.launches - before != 3:
        raise AssertionError(f"3 batched calls made {wideband_energy_fused.launches - before} launches")
    one_by_one = torch.stack([
        wideband_energy_fused(bxr[i], bxi[i], taps, wcfg, initial_history=(bhist[0][i], bhist[1][i]))
        for i in range(3)])
    if not (torch.equal(b_planar, one_by_one) and torch.equal(b_planes, b_planar)
            and torch.equal(b_complex, b_planar)):
        raise AssertionError("a batch differs from its streams one by one, or the interleaved or "
                             "complex form from the planar one")
    if not (torch.equal(wideband_energy_fused(bxr[:1], bxi[:1], taps, wcfg)[0],
                        wideband_energy_fused(bxr[0], bxi[0], taps, wcfg))
            and torch.equal(wideband_energy_fused_planes(bplanes, taps, wcfg, initial_history=bhist),
                            b_planes)):
        raise AssertionError("B=1 differs from the unbatched call, or a batch from run to run")
    want_b = wideband_energy_fused_planes_plain(bplanes, taps, wcfg, precision="highest",
                                                initial_history=bhist)
    torch.testing.assert_close(b_planes, want_b, rtol=1e-5, atol=1e-7)
    b_err = (b_planes - want_b).abs().max().item()
    wide_err = max(wide_err, b_err)
    phase("wideband-vs-plain", f"a (3, {4096 * m}, 2) batch with a history per stream: one launch "
          f"a call; planar, interleaved and complex64 input and each stream launched alone "
          f"torch.equal; B=1 equals the unbatched call; within rtol 1e-5, atol 1e-7 of the plain "
          f"version (max abs err {b_err:.3e})")
    del bplanes, bhist, bxr, bxi, b_planar, b_planes, b_complex, one_by_one, want_b

    # 11. the wideband path at full width
    n_wide = WIDE_T * m
    table = 2.0 * np.pi * np.arange(m) / m
    cos_t = torch.from_numpy(np.cos(table).astype(np.float32)).to(dev)
    sin_t = torch.from_numpy(np.sin(table).astype(np.float32)).to(dev)

    def scene(n: int):
        """Planar scene: 1e-3 noise plus a unit tone at each active channel's centre."""
        sr = 1e-3 * torch.randn(n, generator=g, device=dev)
        si = 1e-3 * torch.randn(n, generator=g, device=dev)
        idx = torch.arange(n, device=dev)
        for k in WIDE_ACTIVE:
            ph = (idx * k) % m  # exp(2 pi i k n / M) repeats every M samples
            sr += cos_t[ph]
            si += sin_t[ph]
        return sr, si

    sr, si = scene(n_wide)
    fn = make_wideband_fn(wcfg)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = fn((sr, si))
    torch.cuda.synchronize()
    wide_s = time.perf_counter() - t0
    wide_launches = wideband_energy_fused.launches
    if wide_launches < 1:
        raise AssertionError("the wideband path did not launch the wideband_energy_fused kernel")
    cycles = WIDE_T // bl
    for key, shape in (("energy", (cycles, m)), ("noise", (cycles, 1)), ("occupied", (cycles, m))):
        v = res[key]
        if tuple(v.shape) != shape or not torch.isfinite(v.float()).all():
            raise AssertionError(f"{key}: shape {tuple(v.shape)} or non-finite values")
    expect = torch.zeros(m, dtype=torch.bool, device=dev)
    expect[list(WIDE_ACTIVE)] = True
    wrong = int((res["occupied"][1:] != expect).sum())
    if wrong:
        raise AssertionError(f"occupied differs from the active channels in {wrong} places")
    free = res["energy"][1:, ~expect]
    margin = (free / (wcfg.threshold_ratio * res["noise"][1:])).max().item()
    phase("wideband-path", f"T={WIDE_T} ({n_wide / 1e6:.1f} M wide samples, "
          f"{2 * n_wide * 4 / 1e6:.0f} MB of f32 planes), {cycles} cycles through "
          f"make_wideband_fn in {wide_s * 1e3:.1f} ms host time (first call); kernel launches "
          f"{wide_launches}; occupied == channels {list(WIDE_ACTIVE)} in every cycle after the "
          f"first; active energy {res['energy'][1:, expect].min().item():.4f} at least, a free "
          f"channel reaches {margin:.3f} of the threshold at most")
    # the serving end: features and the per-channel MLP over a batch of streams
    feats = wideband_features(res["energy"], res["noise"])
    if tuple(feats.shape) != (cycles, m, 4) or not torch.isfinite(feats).all():
        raise AssertionError(f"wideband_features: shape {tuple(feats.shape)} or non-finite values")
    del sr, si, res, feats
    mlp = OccupancyMLP(4, 5, 1, device=dev)
    with torch.no_grad():
        for prm in mlp.parameters():
            prm.normal_(generator=g)
    batch = torch.stack(
        [torch.stack(scene(APPLY_T * m), dim=-1) for _ in range(APPLY_BATCH)]
    )  # (B, T*M, 2)
    apply_fn = make_sharded_apply(wcfg)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    probs = apply_fn(mlp, batch)
    torch.cuda.synchronize()
    apply_s = time.perf_counter() - t0
    apply_launches = wideband_energy_fused.launches
    if apply_launches != 1:
        raise AssertionError(f"the apply step launched the wideband_energy_fused kernel "
                             f"{apply_launches} times for a batch of {APPLY_BATCH} streams, not once")
    packed = fn(batch, use_fused=False)
    if wideband_energy_fused.launches != apply_launches:
        raise AssertionError("use_fused=False launched the kernel")
    by_kernel = fn(batch)
    torch.testing.assert_close(by_kernel["energy"], packed["energy"], rtol=1e-5, atol=1e-7)
    if not torch.equal(by_kernel["occupied"], packed["occupied"]):
        raise AssertionError("a batch's occupied differs between the kernel and the packed path")
    if tuple(probs.shape) != (APPLY_BATCH, APPLY_T // bl, m):
        raise AssertionError(f"apply: shape {tuple(probs.shape)}")
    if not bool(((probs > 0) & (probs < 1)).all()):
        raise AssertionError("apply: probabilities outside (0, 1)")
    phase("wideband-path", f"make_sharded_apply on a ({APPLY_BATCH}, {APPLY_T * m}, 2) batch with "
          f"a seeded 4-5-1 network: probabilities {tuple(probs.shape)} in (0, 1) "
          f"[{probs.min().item():.4f}, {probs.max().item():.4f}] in {apply_s * 1e3:.1f} ms host "
          f"time (first call); kernel launches {apply_launches}, one for the batch; the batch's "
          f"energy within rtol 1e-5, atol 1e-7 of the packed plain path (use_fused=False, 0 "
          f"launches) and occupied equal")
    del packed, by_kernel, probs

    # 12. features-only sense, kernel vs plain on the card
    scfg = SenseConfig()
    a, n = scfg.averaging, scfg.fft_length
    dense_err = 0.0
    dense_inputs = None
    for c in (CYCLES, 5):
        planes = (torch.randn(c * a, n, generator=g, device=dev),
                  torch.randn(c * a, n, generator=g, device=dev))
        got = fused_band_features(planes, averaging=a)
        want = fused_band_features_plain(planes, averaging=a)
        _, ct = fused_sense_ct(*planes, averaging=a)
        again = fused_band_features(planes, averaging=a)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=0.0)
        torch.testing.assert_close(got, ct, rtol=1e-6, atol=0.0)
        if not torch.equal(got, again):
            raise AssertionError(f"fused_band_features differs from run to run at C={c}")
        dense_err = max(dense_err, (got - want).abs().max().item())
        rel = ((got - want).abs() / want.abs()).max().item()
        rel_ct = ((got - ct).abs() / ct.abs()).max().item()
        phase("dense-vs-plain", f"C={c}: feats max rel err {rel:.3e} vs the dense plain version "
              f"(rtol 1e-4), {rel_ct:.3e} vs fused_sense_ct (rtol 1e-6; equal bits: "
              f"{torch.equal(got, ct)}); equal from run to run")
        if c == CYCLES:
            dense_inputs = planes
    # the function on the sense scene of phase 4, through the MLP and the decision rule
    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad():
        feats = fused_band_features(sense_planar, averaging=a)
        dec = occupancy_decision(params(feats), scfg.threshold)
    torch.cuda.synchronize()
    dense_launches = fused_band_features.launches
    if dense_launches < 1:
        raise AssertionError("fused_band_features did not launch its kernel")
    if tuple(feats.shape) != (CYCLES, 4) or not torch.isfinite(feats).all():
        raise AssertionError(f"dense features: shape {tuple(feats.shape)} or non-finite values")
    hit = float((dec == pu_trace + 1).float().mean())
    if hit < 0.99:
        raise AssertionError(f"features path: decision == PU channel + 1 on only {hit:.4f} of cycles")
    phase("dense-path", f"fused_band_features on the {CYCLES}-cycle sense scene -> MLP -> "
          f"decision: kernel launches {dense_launches}; decision == PU+1 on {hit:.4f}")

    # 13. times: in turns plain, kernel, kernel, plain
    def turns(kern, plain, inputs):
        plain_1 = time_ms(plain, inputs)
        kern_1 = time_ms(kern, inputs)
        kern_2 = time_ms(kern, inputs)
        plain_2 = time_ms(plain, inputs)
        return (statistics.median(kern_1), statistics.median(plain_1),
                statistics.median(kern_2), statistics.median(plain_2))

    def wide_kern(xr, xi):
        return wideband_energy_fused(xr, xi, taps, wcfg, precision="highest")

    def wide_plain(xr, xi):
        return wideband_energy_fused_plain(xr, xi, taps, wcfg, precision="highest")

    wk, wp, wk2, wp2 = turns(wide_kern, wide_plain, [big])
    read = 2 * n_wide * 4

    def wide_bound_of(t: int) -> tuple[float, str]:
        # per row: the FIR (2 planes x 64 channels x 8 taps x 2), a 64-point
        # complex FFT (5 N log2 N) and the power (3 x 64)
        return bound(2 * t * m * 4 + taps.numel() * 4 + t // bl * m * 4,
                     t * (2 * m * 8 * 2 + 5 * m * 6 + 3 * m))

    gbs = read / (wk * 1e-3) / 1e9
    wide_bound, wide_by = wide_bound_of(WIDE_T)
    wide_bound_of_batch = wide_bound_fn(APPLY_BATCH, APPLY_T)[0]
    phase("time", f"wideband T={WIDE_T} ({n_wide / 1e6:.1f} M wide samples): kernel {wk:.4f} "
          f"ms/dispatch ({n_wide / wk / 1e3:.0f} MS/s, {gbs:.0f} GB/s read, "
          f"{gbs / 3350:.1%} of 3.35 TB/s; bound {wide_bound:.4f} ms by {wide_by}), plain "
          f"{wp:.4f} ms/dispatch ({n_wide / wp / 1e3:.0f} MS/s), median of 3; second turn kernel "
          f"{wk2:.4f}, plain {wp2:.4f}; {smi}")
    # the kernel alone (profile_wideband.py): single streams at T/4, T/2 and T,
    # which a rank of a 4- or 2-way time split gets, with no other process on
    # the card, and the train step's batch, planar and interleaved
    prof = measure(dev, smi, "[time] wideband kernel alone:")
    batch_row = next(r for r in prof["rows"] if r["case"].endswith("planar"))
    sense_t = time_ms(fn, [(big,)])
    sense_ms = statistics.median(sense_t)
    phase("time", f"make_wideband_fn T={WIDE_T}: {sense_ms:.4f} ms/call "
          f"({n_wide / sense_ms / 1e3:.0f} MS/s), median of 3 runs of 10 calls (runs "
          f"{', '.join(f'{t:.4f}' for t in sense_t)}); {smi}")
    bk, bp, bk2, bp2 = turns(fn, lambda b: fn(b, use_fused=False), [(batch,)])
    phase("time", f"make_wideband_fn on the ({APPLY_BATCH}, {APPLY_T * m}, 2) batch "
          f"({APPLY_BATCH * APPLY_T * m / 1e6:.1f} M wide samples): {bk:.4f} ms/call through the "
          f"kernel, one launch ({APPLY_BATCH * APPLY_T * m / bk / 1e3:.0f} MS/s), {bp:.4f} "
          f"ms/call through the packed plain path, median of 3; second turn kernel {bk2:.4f}, "
          f"plain {bp2:.4f}; {smi}")
    # where a call's time goes: host clock per synchronized call, then the
    # device's operations and busy time per call from a profiler trace
    wall_t = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(5):
            fn(big)
            torch.cuda.synchronize()
        wall_t.append((time.perf_counter() - t0) / 5 * 1e3)
    wall_ms = statistics.median(wall_t)

    def five_calls():
        for _ in range(5):
            with torch.profiler.record_function("wideband_call"):
                fn(big)

    _, _, busy_us, ops = traced(five_calls, "wideband_call", "the wideband call")
    phase("time", f"make_wideband_fn T={WIDE_T}, one synchronized call: {wall_ms:.4f} ms by host "
          f"clock (median of 5 runs of 5: {', '.join(f'{t:.4f}' for t in wall_t)}); profiled: "
          f"{ops / 5:.1f} device operations and {busy_us / 5:.1f} us busy per call, so the device "
          f"idles {1 - busy_us / 5 / (wall_ms * 1e3):.1%} of an unprofiled call; {smi}")
    # the same samples as interleaved (T*M, 2) planes, and the batch: read in
    # place, so a call makes no copy kernel and as many operations as the planar one
    inter = torch.stack(big, dim=-1)
    for label, arg in (("interleaved", inter), ("batch", batch)):
        def five_inter(arg=arg, label=label):
            for _ in range(5):
                with torch.profiler.record_function(f"wideband_{label}_call"):
                    fn(arg)

        trace, _, i_busy, i_ops = traced(five_inter, f"wideband_{label}_call", f"the {label} call")
        calls = span_kernels(trace, f"wideband_{label}_call")
        copies = [k for c in calls for k in c if "copy" in k.lower()]
        if len(calls) != 5 or copies or i_ops != ops:
            raise AssertionError(f"a {label} make_wideband_fn call made {i_ops / 5:.1f} device "
                                 f"operations (the planar call {ops / 5:.1f}), copies {copies}")
        phase("time", f"make_wideband_fn on {label} planes {tuple(arg.shape)}: {i_ops / 5:.1f} "
              f"device operations and {i_busy / 5:.1f} us busy per call, as many as the planar "
              f"call's {ops / 5:.1f}, and no copy kernel: the planes are read in place (a call: "
              f"{', '.join(short_name(k) for k in calls[0])}); {smi}")
    del big, inter, batch

    def dense_kern(xr, xi):
        return fused_band_features((xr, xi), averaging=a)

    def dense_plain(xr, xi):
        return fused_band_features_plain((xr, xi), averaging=a)

    dk, dp, dk2, dp2 = turns(dense_kern, dense_plain, [dense_inputs])
    # The bound is the function's: the planes, the twiddle and band tables read
    # once, the features written once and, per sample, the 9 radix-2 stages of
    # a 512-point FFT (5 flops each) and the magnitude, as for fused_sense_ct
    # less its spectrum.
    dense_bound, dense_by = bound(CYCLES * a * n * 8 + n * 8 + n * 16 + CYCLES * 16,
                                  CYCLES * a * n * (5 * 9 + 3))
    gbs = CYCLES * a * n * 8 / (dk * 1e-3) / 1e9
    phase("time", f"features-only sense C={CYCLES}: kernel {dk:.4f} ms/dispatch "
          f"({gbs:.0f} GB/s read, {gbs / 3350:.1%} of 3.35 TB/s; bound {dense_bound:.4f} ms by "
          f"{dense_by}, so {dk / dense_bound:.2f}x its bound; as a dense product it took "
          f"{DENSE_PRODUCT_MS} ms: {DENSE_PRODUCT_MS / dk:.1f}x), plain {dp:.4f} ms/dispatch, "
          f"median of 3; second turn kernel {dk2:.4f}, plain {dp2:.4f}; {smi}")
    return [
        {
            "name": "wideband_energy_fused",
            "route": "cuda",
            "source": WIDE_SOURCE,
            "replaces": WIDE_REPLACES,
            "launches": wide_launches,
            "max_abs_err": wide_err,
            "ms": wk,
            "plain_ms": wp,
            "bound_ms": wide_bound,
            "bound_by": wide_by,
            "library_ms": None,  # FIR + DFT + power + block mean: no single PyTorch call
            # the (4, 65,536) batch of the train step in one launch, planar, by CUDA events
            "batch_ms": statistics.median(batch_row["events_ms"]),
            "batch_bound_ms": wide_bound_of_batch,
        },
        {
            "name": "fused_band_features",
            "route": "cuda",
            "source": DENSE_SOURCE,
            "replaces": DENSE_REPLACES,
            "launches": dense_launches,
            "max_abs_err": dense_err,
            "ms": dk,
            "plain_ms": dp,
            "bound_ms": dense_bound,
            "bound_by": dense_by,
            "library_ms": None,  # DFT + magnitude + mean + band sums: no single PyTorch call
        },
    ]


def adaptive_blocks(dev):
    """The adaptive stream of phase 17 (bench.py:324-374), made on the card:
    ``STREAM_FRAMES`` frames of ``STREAM_PAYLOAD`` bytes alternating
    qam4/h128 and qam16/none, each followed by ``STREAM_GAP`` zeros, cut into
    ``STREAM_BLOCKS`` blocks of contiguous planes.  Returns (blocks, headers,
    payloads, samples per pair of frames)."""
    import dataclasses

    import numpy as np
    import torch

    from cognitive_radio_network_tpu_torch.phy import OFDMFrameConfig, OFDMFrameGen

    cfg_a = OFDMFrameConfig()
    cfg_b = dataclasses.replace(cfg_a, mod_scheme="qam16", fec0="none")
    rng = np.random.default_rng(17)
    hdrs = rng.integers(0, 256, (STREAM_FRAMES, 8)).astype(np.uint8)
    pays = rng.integers(0, 256, (STREAM_FRAMES, STREAM_PAYLOAD)).astype(np.uint8)
    gen_a, gen_b = OFDMFrameGen(cfg_a, STREAM_PAYLOAD), OFDMFrameGen(cfg_b, STREAM_PAYLOAD)
    fr_a = gen_a.assemble(hdrs[0::2], pays[0::2], as_planes=True, device=dev)
    fr_b = gen_b.assemble(hdrs[1::2], pays[1::2], as_planes=True, device=dev)
    gap = torch.zeros((STREAM_FRAMES // 2, STREAM_GAP, 2), device=dev)
    pair = torch.cat([fr_a, gap, fr_b, gap], dim=1)  # frame a, gap, frame b, gap
    whole = pair.reshape(-1, 2)
    a_blk = whole.shape[0] // STREAM_BLOCKS
    blocks = [(whole[i * a_blk : (i + 1) * a_blk, 0].contiguous(),
               whole[i * a_blk : (i + 1) * a_blk, 1].contiguous()) for i in range(STREAM_BLOCKS)]
    return blocks, hdrs, pays, pair.shape[1]


def stream_phases(dev, smi: str) -> tuple[dict, dict, dict]:
    """Phases 14-17: the resolve kernel against its plain version, the
    adaptive gate, the three streaming APIs, and the adaptive stream at full
    width with its times.  Returns the resolve kernel's entry of the kernels
    line, what the stream step showed of the extract kernel (its launches per
    step, its error against the plain version on the step's own windows, and
    its times and bound at the step's widest shape) and what the v27+v27
    stream showed of the Viterbi kernel (launches, ``process`` calls and the
    frames it decoded)."""
    import dataclasses
    import warnings

    import numpy as np
    import torch

    from cognitive_radio_network_tpu_torch.ops.extract import (
        extract_window_sets,
        extract_window_sets_plain,
        extract_windows,
        window_buffers,
    )
    from cognitive_radio_network_tpu_torch.ops.resolve import (
        resolve_candidates,
        resolve_candidates_plain,
    )
    from cognitive_radio_network_tpu_torch.ops.viterbi import viterbi_decode_k7
    from cognitive_radio_network_tpu_torch.profile_extract import device_us_per_launch, gather_bytes
    from cognitive_radio_network_tpu_torch.utils import profiling
    from cognitive_radio_network_tpu_torch.phy import (
        OFDMFrameConfig,
        OFDMFrameGen,
        StreamReceiver,
    )

    cfg_a = OFDMFrameConfig()
    cfg_b = dataclasses.replace(cfg_a, mod_scheme="qam16", fec0="none")

    resolve_err = 0.0

    def equal_or_raise(got, want, what):
        """Accept flags and meta ``torch.equal`` to the plain version's, or
        raise; the error kept is the larger of the flags that differ and the
        meta's largest difference."""
        nonlocal resolve_err
        err = max((got[0] != want[0]).sum().item(), (got[1] - want[1]).abs().max().item())
        resolve_err = max(resolve_err, float(err))
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"resolve kernel differs from the plain version at {what}")

    # 14a. resolve, kernel vs plain on random tables (the full-width columns follow in 17)
    rng = np.random.default_rng(3)
    for k in (1, 16, 256, 257, 520, 1500):
        n_buf, prefix = 2_800_000, 304
        offs = np.sort(rng.integers(0, n_buf + 3000, k))
        cols = (offs, rng.uniform(0, 1, k).astype(np.float32), rng.uniform(0, 1, k) < 0.9,
                rng.integers(prefix, 6000, k), np.array([int(rng.integers(0, n_buf))]))
        cols = tuple(torch.from_numpy(c).to(dev) for c in cols)
        got = resolve_candidates(*cols, 0.2, n_buf, prefix)
        torch.cuda.synchronize()
        equal_or_raise(got, resolve_candidates_plain(*cols, 0.2, n_buf, prefix), f"random K={k}")
    phase("resolve-vs-plain", "random candidate tables, K in (1, 16, 256, 257, 520, 1500): "
          "accept flags and meta torch.equal to the plain version")

    def noise(rng, n, scale=0.003):
        return (scale * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)

    def planes(seg):
        return (torch.from_numpy(seg.real.copy()).to(dev), torch.from_numpy(seg.imag.copy()).to(dev))

    def place(stream, specs, rng, pos, gap):
        """Frames of (config, payload bytes) in turn into ``stream``; returns
        [(offset, payload, mod)]."""
        placed = []
        for cfg, plen in specs:
            gen = OFDMFrameGen(cfg, plen)
            if pos + gen.frame_len + 50 >= len(stream):
                break
            h = rng.integers(0, 256, (1, 8)).astype(np.uint8)
            pay = rng.integers(0, 256, (1, plen)).astype(np.uint8)
            iq = gen.assemble(h, pay)[0].cpu().numpy()  # assembled on the card
            stream[pos : pos + len(iq)] += iq
            placed.append((pos, pay[0], cfg.mod_scheme))
            pos += len(iq) + (gap() if callable(gap) else gap)
        return placed

    def check_frames(frames, placed, what):
        if len(frames) != len(placed):
            raise AssertionError(f"{what}: {len(frames)} frames for {len(placed)} placed")
        for fr, (off, pay, mod) in zip(frames, placed):
            if abs(fr["offset"] - off) > 2 or not fr["stats"].payload_valid:
                raise AssertionError(f"{what}: frame at {fr['offset']} for {off}, or a bad CRC")
            if not np.array_equal(fr["payload"], pay) or fr["stats"].mod_scheme != mod:
                raise AssertionError(f"{what}: payload or scheme differs at {off}")

    def same_frames(a, b, what):
        if [f["offset"] for f in a] != [f["offset"] for f in b]:
            raise AssertionError(f"{what}: offsets differ")
        for x, y in zip(a, b):
            if not (np.array_equal(x["header"], y["header"])
                    and np.array_equal(x["payload"], y["payload"])):
                raise AssertionError(f"{what}: header or payload differs at {x['offset']}")

    # 15. the adaptive gate (port of tests/tpu_gates.py::gate_adaptive_stream)
    rng = np.random.default_rng(5)
    n_gate = 16000
    stream = noise(rng, n_gate)
    placed = place(stream, [(cfg_a, 64), (cfg_b, 48)] * 3, rng, 60, 911)
    rx = StreamReceiver(cfg_a, max_frames_per_block=8)  # on the card: its default
    torch.cuda.synchronize()
    reset_counts()
    frames, steps = [], 0
    for s0 in range(0, n_gate, 2048):  # blocks of 2048 -> straddlers
        frames += rx.process_device(*planes(stream[s0 : s0 + 2048]))
        steps += 1
    check_frames(frames, placed, "adaptive gate")
    if resolve_candidates.launches != steps or extract_windows.launches < 2 * steps:
        raise AssertionError(
            f"adaptive gate: {resolve_candidates.launches} resolve and "
            f"{extract_windows.launches} extract launches in {steps} steps")
    phase("adaptive-gate", f"{len(placed)} frames (qam4/h128 64 B, qam16/none 48 B) in "
          f"{n_gate} samples, {steps} blocks of 2048 through StreamReceiver(cfg).process_device: "
          f"every frame within 2 samples, payloads equal, CRCs good; resolve launches "
          f"{resolve_candidates.launches}, extract launches {extract_windows.launches}")

    # 16. the three APIs on one random mixed-config stream, and the CPU run
    rng = np.random.default_rng(0)
    n_mix = 40000
    stream = noise(rng, n_mix, 0.004)
    mods, fecs = ["qam4", "qam16", "bpsk"], ["h128", "none", "rep3"]
    specs = [(dataclasses.replace(cfg_a, mod_scheme=mods[rng.integers(0, 3)],
                                  fec0=fecs[rng.integers(0, 3)]), int(rng.integers(8, 120)))
             for _ in range(40)]
    placed = place(stream, specs, rng, int(rng.integers(0, 400)),
                   lambda: int(rng.integers(300, 1200)))
    blk = int(rng.integers(900, 4000))
    rxs = {"process": StreamReceiver(cfg_a), "process_device": StreamReceiver(cfg_a),
           "feed_device": StreamReceiver(cfg_a), "cpu": StreamReceiver(cfg_a, device="cpu")}
    got = {key: [] for key in rxs}
    for s0 in range(0, n_mix, blk):
        seg = stream[s0 : s0 + blk]
        got["process"] += rxs["process"].process(seg)
        got["process_device"] += rxs["process_device"].process_device(*planes(seg))
        got["feed_device"] += rxs["feed_device"].feed_device(
            *planes(seg), max_lag=int(rng.integers(0, 5)))
        got["cpu"] += rxs["cpu"].process(seg)
    got["feed_device"] += rxs["feed_device"].flush()
    check_frames(got["process"], placed, "three APIs, process")
    for key in ("process_device", "feed_device", "cpu"):
        same_frames(got[key], got["process"], f"three APIs, {key} vs process")
    phase("three-apis", f"{len(placed)} frames of random configs (qam4/qam16/bpsk x "
          f"h128/none/rep3, 8-119 byte payloads) in {n_mix} samples, blocks of {blk}: process, "
          f"process_device, feed_device/flush (random lags) and the CPU run of process give "
          f"equal offsets, headers and payloads, equal to those sent")
    # a Viterbi-coded stream at a small size: right, slow, not timed
    cfg_v = dataclasses.replace(cfg_a, mod_scheme="qam16", fec0="v27")
    rng = np.random.default_rng(9)
    stream = noise(rng, 9000)
    placed = place(stream, [(cfg_a, 40), (cfg_v, 96)] * 2, rng, 300, 300)
    rx = StreamReceiver(cfg_a, max_frames_per_block=8)
    t0 = time.perf_counter()
    frames = []
    for s0 in range(0, len(stream), 3000):
        frames += rx.process_device(*planes(stream[s0 : s0 + 3000]))
    check_frames(frames, placed, "v27 stream")
    phase("three-apis", f"{len(placed)} frames alternating qam4/h128 and qam16/v27 through "
          f"process_device in 3 blocks: all intact in {time.perf_counter() - t0:.2f} s host time "
          f"(first calls)")
    # predictive_model.cfg's link (qam16, crc32, v27+v27) beside qam4/h128
    # through process, the counts at 0 just before it: the Viterbi kernel's
    # launches per call, the frames it decoded and no host step of the loop
    cfg_vv = dataclasses.replace(cfg_v, fec1="v27")
    rng = np.random.default_rng(10)
    stream = noise(rng, 12000)
    placed = place(stream, [(cfg_a, 40), (cfg_vv, 96)] * 2, rng, 300, 300)
    if [mod for _, _, mod in placed] != ["qam4", "qam16"] * 2:
        raise AssertionError(f"v27+v27 stream: {len(placed)} frames placed, not 4")
    rx = StreamReceiver(cfg_a, max_frames_per_block=8)
    torch.cuda.synchronize()
    reset_counts()
    frames, calls = [], 0
    with profiling.recording() as recs:
        for s0 in range(0, len(stream), 3000):
            frames += rx.process(stream[s0 : s0 + 3000])
            calls += 1
    counts = {}
    for c in profiling.calls(recs):
        for k, v in c["counts"].items():
            counts[k] = counts.get(k, 0) + v
    check_frames(frames, placed, "v27+v27 stream")
    viterbi = {"launches": viterbi_decode_k7.launches, "process_calls": calls,
               "kernel_frames": counts.get("fec.viterbi_kernel_frames", 0)}
    if "fec.viterbi_host_steps" in counts or viterbi["kernel_frames"] != 4:
        raise AssertionError(f"v27+v27 stream: counts {counts}, not 4 kernel frames (the inner "
                             f"and the outer code of 2 frames) and no host step")
    if not 2 <= viterbi["launches"] <= 4 or viterbi["launches"] % 2:
        raise AssertionError(f"v27+v27 stream: {viterbi['launches']} Viterbi launches for 2 "
                             f"frames, not 2 per decoded group of frames")
    phase("three-apis", f"{len(placed)} frames alternating qam4/h128 and qam16/v27+v27 through "
          f"process in {calls} blocks: all intact; Viterbi launches {viterbi['launches']} "
          f"({viterbi['launches'] / calls:.3g} per process call), kernel frames "
          f"{viterbi['kernel_frames']} (both codes of each v27+v27 frame), host steps 0")

    # 17. the adaptive stream at full width (bench.py:324-374)
    t0 = time.perf_counter()
    blocks, hdrs, pays, pair_len = adaptive_blocks(dev)
    gen_a, gen_b = OFDMFrameGen(cfg_a, STREAM_PAYLOAD), OFDMFrameGen(cfg_b, STREAM_PAYLOAD)
    a_blk = blocks[0][0].shape[0]
    n_ad = STREAM_BLOCKS * a_blk
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    srx = StreamReceiver(cfg_a, max_frames_per_block=STREAM_FRAMES // STREAM_BLOCKS + 8)
    srx.fetch_group = STREAM_GROUP
    call_ms: list[float] = []

    def adaptive_pass(passes: int):
        out = []
        for _ in range(passes):
            for br, bi in blocks:
                t1 = time.perf_counter()
                out += srx.feed_device(br, bi, threshold=0.2, max_lag=STREAM_LAG)
                call_ms.append((time.perf_counter() - t1) * 1e3)
        out += srx.flush()
        return out

    want_offs = np.arange(STREAM_FRAMES // 2)[:, None] * pair_len + np.array(
        [0, gen_a.frame_len + STREAM_GAP])
    want_offs = want_offs.reshape(-1)

    def check_pass(frames0, base):
        if len(frames0) != STREAM_FRAMES:
            raise AssertionError(f"adaptive stream: {len(frames0)} frames, not {STREAM_FRAMES}")
        if not np.array_equal(np.stack([f["payload"] for f in frames0]), pays):
            raise AssertionError("adaptive stream: decoded payloads differ from those sent")
        if not np.array_equal(np.stack([f["header"] for f in frames0]), hdrs):
            raise AssertionError("adaptive stream: decoded headers differ from those sent")
        if not all(f["stats"].payload_valid for f in frames0):
            raise AssertionError("adaptive stream: a payload CRC failed")
        mods_got = [f["stats"].mod_scheme for f in frames0]
        if mods_got[0::2] != ["qam4"] * (STREAM_FRAMES // 2) or \
                mods_got[1::2] != ["qam16"] * (STREAM_FRAMES // 2):
            raise AssertionError("adaptive stream: modulations do not alternate qam4, qam16")
        offs = np.array([f["offset"] for f in frames0]) - base
        if np.abs(offs - want_offs).max() > 2:
            raise AssertionError("adaptive stream: a frame lies more than 2 samples off")

    # the first passes also settle the speculated configs and PyTorch's allocators
    first_s = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames0 = adaptive_pass(1)
        first_s.append(time.perf_counter() - t0)
        check_pass(frames0, i * n_ad)
    # one pass with the counts at 0 just before it: the kernels' launches per step
    torch.cuda.synchronize()
    reset_counts()
    frames0 = adaptive_pass(1)
    torch.cuda.synchronize()
    check_pass(frames0, 3 * n_ad)
    resolve_launches = resolve_candidates.launches
    extract_launches = extract_windows.launches
    # a step with two speculated configs and no fallback: the refinement
    # windows, then the header and both configs' frame windows in one launch
    if resolve_launches != STREAM_BLOCKS or extract_launches != 2 * STREAM_BLOCKS:
        raise AssertionError(f"a pass of {STREAM_BLOCKS} steps launched resolve "
                             f"{resolve_launches} and extract {extract_launches} times, not "
                             f"{STREAM_BLOCKS} and {2 * STREAM_BLOCKS}")
    phase("adaptive-stream", f"{STREAM_FRAMES} frames x {STREAM_PAYLOAD} B alternating qam4/h128 "
          f"({gen_a.frame_len} samples) and qam16/none ({gen_b.frame_len}), gap {STREAM_GAP}: N "
          f"{n_ad} in {STREAM_BLOCKS} blocks of {a_blk}, built on the card in {build_s:.2f} s; "
          f"StreamReceiver(cfg) with max_frames_per_block "
          f"{srx.max_frames_per_block}, fetch_group {STREAM_GROUP}, feed_device(max_lag="
          f"{STREAM_LAG}) + flush: {STREAM_FRAMES}/{STREAM_FRAMES} frames in each of 4 passes, "
          f"headers and payloads equal to those sent, mods alternate, all CRCs good, offsets "
          f"within 2 samples; first three passes {', '.join(f'{t:.3f}' for t in first_s)} s; per "
          f"pass of {STREAM_BLOCKS} steps: resolve launches {resolve_launches}, extract launches "
          f"{extract_launches} ({extract_launches / STREAM_BLOCKS:g} per step: the refinement "
          f"windows, then the header windows and both speculated configs' frame windows in one)")

    # 14b. the resolve kernel on the stream's own columns: one step's scan
    from cognitive_radio_network_tpu_torch.phy import framesync, stream as stream_mod

    r_cap = framesync._bucket_len(srx.max_residual)
    buf = [torch.cat([torch.zeros(r_cap, device=dev), b]) for b in blocks[0]]
    n_buf = buf[0].shape[0]
    k_step = min(srx.max_frames_per_block, max(4, -(-n_buf // srx.prefix_len)))
    bests, peaks, _, _, phy, hdr_ok = framesync._scan_block_graph(srx.layout, *buf, n_buf, k=k_step)
    flen, valid = stream_mod._phy_geometry(srx.layout, phy)
    order = torch.argsort(bests, stable=True)
    cols = (bests[order], peaks[order], (hdr_ok & valid)[order], flen[order],
            torch.full((1,), n_buf - srx.prefix_len, dtype=torch.int64, device=dev))
    args = (*cols, 0.2, n_buf, srx.prefix_len)
    got = resolve_candidates(*args)
    want = resolve_candidates_plain(*args)
    equal_or_raise(got, want, f"the stream's K={k_step} columns")
    n_acc = int(got[0].sum())
    if n_acc < STREAM_FRAMES // STREAM_BLOCKS - 1:
        raise AssertionError(f"the walk accepted {n_acc} of the block's frames")
    r_plain_1 = time_ms(resolve_candidates_plain, [args], reps=5)
    r_kern_1 = time_ms(resolve_candidates, [args], reps=200)
    r_kern_2 = time_ms(resolve_candidates, [args], reps=200)
    r_plain_2 = time_ms(resolve_candidates_plain, [args], reps=5)
    rk, rp = statistics.median(r_kern_1), statistics.median(r_plain_1)
    # 21 bytes read and 1 written per candidate, and the meta; about 10 integer operations each
    r_bound, r_by = bound(k_step * 22 + 8 + 24, k_step * 10)
    phase("resolve-vs-plain", f"the stream's first block, K={k_step} candidates in offset order "
          f"({n_acc} accepted): accept flags and meta torch.equal to the plain version "
          f"(max abs err {resolve_err:.1e} over phases 14a and 14b)")
    phase("time", f"resolve K={k_step}: kernel {rk:.4f} ms/call (bound {r_bound:.6f} ms by "
          f"{r_by}: a chain of K dependent steps in one thread, so its time is latency), plain "
          f"version (device-to-host copy, host loop, copy back) {rp:.4f} ms/call and it waits for "
          f"the device; median of 3; second turn kernel "
          f"{statistics.median(r_kern_2):.4f}, plain {statistics.median(r_plain_2):.4f}; {smi}")
    del cols, args

    # 7b. extract, kernel vs plain on the stream step's own windows: the step's
    # buffer and its K candidates, the step's two launches (the refinement
    # windows; the header and both configs' frame windows in one launch), and
    # candidates within 4864 of the buffer's end, where each set clips alone
    span = cfg_a.cp_len + cfg_a.num_subcarriers  # the refinement's reach (framesync._refine)
    ref_wlen = 2 * span + 2 * cfg_a.num_subcarriers
    fused = (srx.prefix_len, gen_a.frame_len, gen_b.frame_len)
    near_end = bests.clone()
    near_end[:8] = n_buf - torch.tensor([4864, 4000, 3000, 2081, 2080, 1000, 689, 1], device=dev)
    step_cases = [
        ("the step's header and frame windows, one launch", bests, fused),
        ("the scan's refinement windows", (bests - span).clamp(0, n_buf - ref_wlen), (ref_wlen,)),
        ("candidates within 4864 of the buffer's end, one launch", near_end, fused),
    ]
    extract_err = 0.0
    for label, offs, wlens in step_cases:
        got = extract_window_sets(*buf, offs, wlens)
        want = extract_window_sets_plain(*buf, offs, wlens)
        into = extract_window_sets(*buf, offs, wlens, out=window_buffers(buf[0], len(offs), wlens))
        torch.cuda.synchronize()
        for (gr, gi), (wr, wi), (ir, ii) in zip(got, want, into):
            if not (torch.equal(gr, wr) and torch.equal(gi, wi) and torch.equal(ir, wr)
                    and torch.equal(ii, wi)):
                raise AssertionError(f"extract kernel differs from the plain version at {label}")
            extract_err = max(extract_err, (gr - wr).abs().max().item(), (gi - wi).abs().max().item())
        # near the end the header window is not a prefix of the frame window
        clipped = sum(not torch.equal(got[0][0][i], got[1][0][i, : wlens[0]]) for i in range(8)) \
            if offs is near_end else 0
        if offs is near_end and clipped == 0:
            raise AssertionError("no candidate near the end clipped its sets apart")
        phase("extract-vs-plain", f"stream step, N={n_buf} K={k_step} wlens "
              f"{'+'.join(map(str, wlens))} ({label}): torch.equal on both planes of every set, "
              f"into its own windows and the caller's (out=)"
              + (f"; {clipped} of 8 candidates near the end clip the header and frame windows "
                 "to different starts" if offs is near_end else ""))
        del got, want, into

    def step_times(offs, wlens, label):
        """On-card time per launch, CUDA events per call (plain and kernel in
        turns), the wrapper's host time with out=, and the bound."""
        ws = window_buffers(buf[0], len(offs), wlens)

        def kern(*a):
            return extract_window_sets(*a, out=ws)

        inputs = [(*buf, offs, wlens)]
        plain_1 = time_ms(extract_window_sets_plain, inputs)
        kern_1 = time_ms(kern, inputs)
        kern_2 = time_ms(kern, inputs)
        plain_2 = time_ms(extract_window_sets_plain, inputs)
        k_ms, p_ms = statistics.median(kern_1), statistics.median(plain_1)
        dev_us, _ = device_us_per_launch(lambda: kern(*buf, offs, wlens))
        host = host_us(lambda: kern(*buf, offs, wlens))
        nbytes = gather_bytes(offs, n_buf, wlens)
        b_ms, b_by = bound(nbytes, 0)
        gbs = nbytes / (dev_us * 1e-6) / 1e9
        phase("time", f"extract, stream step N={n_buf} K={k_step} wlens {'+'.join(map(str, wlens))} "
              f"({label}): on the card {dev_us:.2f} us per launch (profiler: {gbs:.0f} GB/s, "
              f"{gbs / 3350:.1%} of 3.35 TB/s, {dev_us / 1e3 / b_ms:.2f}x the bound {b_ms:.4f} ms "
              f"by {b_by}: {nbytes / 1e6:.1f} MB, each output byte written and each distinct input "
              f"sample read once); per call by CUDA events: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, median of 3; second turn kernel {statistics.median(kern_2):.4f}, "
              f"plain {statistics.median(plain_2):.4f}; the wrapper's host time with out= "
              f"{host:.3f} us per call; {smi}")
        return k_ms, p_ms, dev_us / 1e3, b_ms, host

    fused_t = step_times(bests, fused, "the header and frame windows, one launch")
    ref_t = step_times(step_cases[1][1], (ref_wlen,), "the refinement windows")
    # the design this replaced, for scale: one launch per set on the same kernel
    per_set_us = sum(device_us_per_launch(lambda w=w: extract_windows(*buf, bests, w))[0]
                     for w in fused)
    phase("time", f"extract, stream step: the step's two launches take {fused_t[2] + ref_t[2]:.4f} "
          f"ms on the card and {fused_t[0] + ref_t[0]:.4f} ms per step by CUDA events; the three "
          f"sets as three launches of the same kernel {per_set_us / 1e3:.4f} ms on the card "
          f"against {fused_t[2]:.4f} in one; {smi}")
    del buf

    # times: 6 passes per trial, median of 3 trials, PyTorch's sync debug mode on
    # "warn" around the trials: a synchronizing call inside a dispatch would warn
    trials = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(3):
                call_ms.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                af = adaptive_pass(STREAM_PASSES)
                ael = time.perf_counter() - t0
                trials.append((STREAM_PASSES * n_ad / ael / 1e6, STREAM_PASSES * STREAM_FRAMES / ael,
                               ael, list(call_ms)))
                if len(af) != STREAM_PASSES * STREAM_FRAMES:
                    raise AssertionError(f"a timed trial decoded {len(af)} frames")
                if not np.array_equal(np.stack([f["payload"] for f in af[:STREAM_FRAMES]]), pays):
                    raise AssertionError("a timed trial's payloads differ from those sent")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught if "synchronizing CUDA operation" in str(w.message)]
    if syncs:
        raise AssertionError(f"{len(syncs)} synchronizing calls inside the timed passes, e.g. "
                             f"{syncs[0]}")
    trials.sort(key=lambda t: t[0])
    msps, fps, ael, calls = trials[1]
    ahead = calls[:STREAM_LAG]  # dispatches that read no step
    reading = calls[STREAM_LAG:]  # dispatches that also read a step 18 behind
    # device time of a pass, back to back: events around a pass whose reads are all deferred
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for br, bi in blocks:
        srx.feed_device(br, bi, threshold=0.2, max_lag=STREAM_LAG)
    stop.record()
    torch.cuda.synchronize()
    pass_dev_ms = start.elapsed_time(stop)
    srx.flush()
    def one_pass():
        with torch.profiler.record_function("stream_pass"):
            adaptive_pass(1)

    _, _, busy_us, ops = traced(one_pass, "stream_pass", "the stream pass")
    pass_ms = ael / STREAM_PASSES * 1e3
    phase("time", f"adaptive stream, {STREAM_PASSES} passes of {STREAM_BLOCKS} blocks per trial "
          f"(N {n_ad} per pass): {msps:.4f} MS/s, {fps:.1f} frames/s, {pass_ms:.3f} ms per pass, "
          f"median of 3 trials (MS/s {', '.join(f'{t[0]:.4f}' for t in trials)}), every payload "
          f"delivered to the host; host time per feed_device call: "
          f"{statistics.median(ahead):.3f} ms median over the {len(ahead)} calls that read no step "
          f"({min(ahead):.3f}-{max(ahead):.3f}), {statistics.median(reading):.3f} ms over the "
          f"{len(reading)} that also read the step {STREAM_LAG} behind "
          f"({min(reading):.3f}-{max(reading):.3f}); synchronizing calls inside the timed passes: "
          f"{len(syncs)} (PyTorch's sync debug mode), so no step waited for the device before it "
          f"fell {STREAM_LAG} behind; {smi}")
    phase("time", f"adaptive stream, one pass of {STREAM_BLOCKS} steps: {pass_dev_ms:.3f} ms by "
          f"CUDA events around 4 dispatches with every read deferred "
          f"({n_ad / pass_dev_ms / 1e3:.1f} MS/s); profiled: {ops / STREAM_BLOCKS:.1f} device "
          f"operations and {busy_us / STREAM_BLOCKS / 1e3:.3f} ms busy per step, so the device "
          f"idles {1 - busy_us / 1e3 / pass_ms:.1%} of an unprofiled pass of {pass_ms:.3f} ms; "
          f"{smi}")
    entry = {
        "name": "resolve_candidates",
        "route": "cuda",
        "source": RESOLVE_SOURCE,
        "replaces": RESOLVE_REPLACES,
        "note": "no TPU kernel: the reference runs this walk as a lax.scan in its step graph",
        "launches": resolve_launches,
        "max_abs_err": resolve_err,  # flags that differ, or the meta's largest difference
        "ms": rk,
        "plain_ms": rp,
        "bound_ms": r_bound,
        "bound_by": r_by,
        "library_ms": None,  # a sequential greedy walk: no PyTorch call computes it
    }
    stream_extract = {
        "launches_per_stream_step": extract_launches / STREAM_BLOCKS,
        "stream_step_max_abs_err": extract_err,
        "stream_step_shape": f"N={n_buf} K={k_step} wlens {'+'.join(map(str, fused))}, one launch",
        "stream_step_ms": fused_t[0],
        "stream_step_device_ms": fused_t[2],
        "stream_step_plain_ms": fused_t[1],
        "stream_step_bound_ms": fused_t[3],
        "stream_step_host_us_with_out": fused_t[4],
    }
    return entry, stream_extract, viterbi


class HostBreakdown:
    """Host time by runtime layer while a scenario runs: class-level wrappers
    around the layers' entry points, restored on exit.  Exclusive times are
    taken by subtraction (the rx front end less ``process``, the tx path less
    the chain).  A wrapper costs about a microsecond per call."""

    def __init__(self):
        from cognitive_radio_network_tpu_torch.engines.predictive_node import CEPredictiveNode
        from cognitive_radio_network_tpu_torch.phy.framegen import OFDMFrameGen
        from cognitive_radio_network_tpu_torch.phy.stream import StreamReceiver
        from cognitive_radio_network_tpu_torch.runtime.medium import Medium
        from cognitive_radio_network_tpu_torch.runtime.node import InterfererNode, RadioNode
        from cognitive_radio_network_tpu_torch.runtime.radio import Radio

        self.targets = {
            "tx": (Radio, "pull_tx_block"),
            "tx_chain": (Radio, "_make_frames_batch"),
            "encode_header": (OFDMFrameGen, "encode_header_batch"),
            "encode_payload": (OFDMFrameGen, "encode_payload_batch"),
            "interferer_tx": (InterfererNode, "pull_tx_block"),
            "medium": (Medium, "propagate"),
            "rx": (Radio, "push_rx_block"),
            "process": (StreamReceiver, "process"),
            "engines": (RadioNode, "run_ce"),
            "classify": (CEPredictiveNode, "_classify_and_act"),
        }
        self.total = {k: 0.0 for k in self.targets}
        self.calls = {k: 0 for k in self.targets}
        self._saved = {}

    def _timed(self, key: str, orig):
        import functools

        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return orig(*args, **kwargs)
            finally:
                self.total[key] += time.perf_counter() - t0
                self.calls[key] += 1

        return wrapper

    def __enter__(self):
        for key, (cls, name) in self.targets.items():
            self._saved[key] = cls.__dict__[name]
            setattr(cls, name, self._timed(key, self._saved[key]))
        return self

    def __exit__(self, *exc):
        for key, (cls, name) in self.targets.items():
            setattr(cls, name, self._saved[key])

    def line(self, steps: int, wall_s: float) -> str:
        """ms per step of each layer, exclusive, and what is left."""
        t = self.total
        encode = t["encode_header"] + t["encode_payload"]
        parts = {
            "tx coding (CRC and FEC of headers and payloads, numpy)": encode,
            "tx chain (assemble+gain+resample on the card, one copy back)": t["tx_chain"] - encode,
            "tx mix and queue": t["tx"] - t["tx_chain"],
            "interferer tx": t["interferer_tx"],
            "medium": t["medium"],
            "rx front end (mix, noise, decimate, squelch)": t["rx"] - t["process"],
            "StreamReceiver.process": t["process"],
            "engines": t["engines"],
        }
        rest = wall_s - sum(parts.values())
        body = "; ".join(f"{k} {v / steps * 1e3:.3f}" for k, v in parts.items())
        return (f"host ms per step over {steps} steps: {body}; other (runtime loop, traffic, "
                f"stats) {rest / steps * 1e3:.3f}; of the engines, classify "
                f"{t['classify'] / steps * 1e3:.3f} ({self.calls['classify']} calls)")


def viterbi_phase(dev, smi: str, stream: dict) -> dict:
    """Phase 17b: the Viterbi kernel against its plain version and its times.
    Returns the kernel's entry of the kernels line, with ``stream``, what the
    v27+v27 stream of phase 16 showed of it."""
    import numpy as np
    import torch

    from cognitive_radio_network_tpu_torch.ops.viterbi import (
        viterbi_decode_k7,
        viterbi_decode_plain,
    )
    from cognitive_radio_network_tpu_torch.phy import fec
    from cognitive_radio_network_tpu_torch.utils.profiling import device_time

    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0])
    rows = []
    for n_bits, frames in VITERBI_SHAPES:
        # encoded random payloads with about 4% of the coded bits flipped
        steps = n_bits + 6
        rng = np.random.default_rng([n_bits, frames])
        coded = fec.conv_encode_bits_batch(rng.integers(0, 2, (frames, n_bits)).astype(np.uint8))
        coded ^= (rng.random(coded.shape) < 0.04).astype(np.uint8)
        host = torch.from_numpy(coded)
        card = host.to(dev)
        got = viterbi_decode_k7(card, n_bits)
        # the plain loop on the card at the path's shapes, on the CPU (the
        # same integers, faster than ~5 launches a step) for the long frame
        long_frame = n_bits > 10_000
        want = viterbi_decode_plain(host if long_frame else card, n_bits).to(dev)
        err = (got.int() - want.int()).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"Viterbi kernel differs from the plain version at {n_bits} "
                                 f"bits x {frames} ({(got != want).sum().item()} bits)")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                viterbi_decode_k7(card, n_bits)
            torch.cuda.synchronize()
        durs = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                if e.device_type.name == "CUDA" and "viterbi" in e.name]
        ms = statistics.median(durs)
        padded = -(-steps // 32) * 32
        # coded bits read, decoded bits written, the selectors written and read back
        bound_ms, bound_by = bound(frames * (2 * steps + n_bits + 16 * padded), 0)
        row = {"n_bits": n_bits, "steps": steps, "frames": frames, "max_abs_err": err, "ms": ms,
               "events_ms": device_time(viterbi_decode_k7, card, n_bits, reps=50)["mean_s"] * 1e3,
               "cycles_per_step": ms * 1e-3 * sm_mhz * 1e6 / steps,
               "host_us": host_us(lambda: viterbi_decode_k7(card, n_bits)),
               "bound_ms": bound_ms, "bound_by": bound_by}
        plain = ""
        if frames == 1 and not long_frame:
            row["plain_ms"] = device_time(viterbi_decode_plain, card, n_bits, reps=1,
                                          warmup=1)["mean_s"] * 1e3
            plain = f"; the plain loop {row['plain_ms']:.1f} ms by CUDA events"
        rows.append(row)
        phase("viterbi", f"{n_bits} bits ({steps} steps) x {frames}: torch.equal to the plain "
              f"version; kernel {ms:.4f} ms on the card (profiler, median of {len(durs)}), "
              f"{row['events_ms']:.4f} ms by CUDA events, {row['cycles_per_step']:.1f} cycles a "
              f"step at {sm_mhz:.0f} MHz; host {row['host_us']:.1f} us a call; bound by "
              f"{bound_by} {bound_ms * 1e3:.4f} us{plain}; {smi}")
    inner = rows[0]
    return {
        "name": "viterbi_decode_k7",
        "route": "cuda",
        "source": VITERBI_SOURCE,
        "replaces": VITERBI_REPLACES,
        "launches": stream["launches"],
        "launches_per_process_call": stream["launches"] / stream["process_calls"],
        "kernel_frames": stream["kernel_frames"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": inner["ms"],
        "events_ms": inner["events_ms"],
        "plain_ms": inner["plain_ms"],
        # bytes are not what bounds it: T dependent steps, forward then back
        "bound_ms": inner["bound_ms"],
        "bound_by": inner["bound_by"],
        "library_ms": None,  # PyTorch has no trellis decoder
        "shapes": rows,
    }


def link_scenario_cfg(run_time: float):
    """The two-node FDD link of tests/test_runtime.py:117-145: 4 MS/s medium,
    16,384-sample blocks, 1 MS/s and 200 kb/s each way."""
    from cognitive_radio_network_tpu_torch.runtime import NodeConfig, ScenarioConfig

    common = dict(tx_rate=1e6, rx_rate=1e6, tx_gain=20.0, rx_gain=20.0, tx_gain_soft=-6.0,
                  ce_timeout_ms=1000.0, net_mean_throughput=200e3)
    return ScenarioConfig(
        num_nodes=2, run_time=run_time, medium_rate=4e6, medium_center=465e6,
        medium_block_len=16384, medium_noise_power=1e-7, name="two_node_link",
        nodes=[NodeConfig(tx_freq=464e6, rx_freq=466e6, **common),
               NodeConfig(tx_freq=466e6, rx_freq=464e6, **common)],
    )


def predictive_variant_cfg(pu_args: str):
    """tests/test_scenarios.py:15-47: a CE_TX_CHANNEL_X PU parked on a channel
    and the CE_Predictive_Node SU at 833 MHz / 13 MS/s, 0.45 s."""
    from cognitive_radio_network_tpu_torch.runtime import NodeConfig, ScenarioConfig

    pu = NodeConfig(cognitive_engine="CE_TX_CHANNEL_X", ce_args=pu_args, ce_timeout_ms=50.0,
                    net_mean_throughput=3e6, tx_freq=833e6, tx_rate=1.3e6, tx_gain=33.0,
                    rx_freq=870e6, rx_rate=1e6)
    su = NodeConfig(cognitive_engine="CE_Predictive_Node", ce_timeout_ms=10.0,
                    net_mean_throughput=1e6, tx_freq=833e6, tx_rate=1e6, tx_gain=25.0,
                    rx_freq=833e6, rx_rate=13e6)
    return ScenarioConfig(num_nodes=2, run_time=0.45, nodes=[pu, su], medium_rate=13e6,
                          medium_center=833e6, medium_block_len=65536, medium_noise_power=1e-7,
                          name="predictive_test")


def profiled(fn, label: str, kernel: str, calls: int = 5):
    """Host clock per synchronized call (median of 5 runs of ``calls``), then
    a profiler trace of ``calls`` calls: device operations, busy us and the
    named kernel's us per call."""
    import torch

    fn()
    torch.cuda.synchronize()
    wall = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) / calls * 1e3)
    def synced_calls():
        for _ in range(calls):
            with torch.profiler.record_function(label):
                fn()
            torch.cuda.synchronize()

    trace, _, busy_us, ops = traced(synced_calls, label, label)
    kern_us = sum(float(e["dur"]) for e in trace["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "kernel" and kernel in e.get("name", ""))
    return statistics.median(wall), ops / calls, busy_us / calls, kern_us / calls


def profile_steps(cfg, warm: int = 20, steps: int = 40) -> tuple[float, float, float]:
    """A fresh runtime of ``cfg`` on the card: ``warm`` steps, then a profiler
    trace of ``steps`` steps.  Returns device operations and busy us per step,
    and the device's idle share of the traced steps' host time."""
    import torch

    from cognitive_radio_network_tpu_torch.runtime import ScenarioRuntime

    rt = ScenarioRuntime(cfg)
    rt.start()
    for _ in range(warm):
        rt.step()
    torch.cuda.synchronize()
    def stepped():
        for _ in range(steps):
            with torch.profiler.record_function("scenario_step"):
                rt.step()

    _, host_us, busy_us, ops = traced(stepped, "scenario_step", f"{steps} steps of {cfg.name}")
    if rt.failed_nodes:
        raise AssertionError(f"{cfg.name}: failed nodes {rt.failed_nodes} while profiled")
    return ops / steps, busy_us / steps, 1 - busy_us / host_us


def scenario_phases(smi: str) -> dict:
    """Phases 18-20: the in-process scenario runtime on the card.  Returns
    the launches of the sense and extract kernels on each scenario path, and
    the summaries the distributed phases are held to."""
    import dataclasses
    from collections import Counter

    import numpy as np
    import torch

    from cognitive_radio_network_tpu_torch import ops
    from cognitive_radio_network_tpu_torch.models import SenseConfig, make_sense_fn
    from cognitive_radio_network_tpu_torch.profile_sense import profiled as sense_profiled
    from cognitive_radio_network_tpu_torch.runtime import ScenarioRuntime, load_scenario
    from cognitive_radio_network_tpu_torch.signal.mlp import reference_weights
    from cognitive_radio_network_tpu_torch.signal.msequence import msequence_bytes

    known = msequence_bytes(256)
    launches = {}

    def run(cfg, **kw):
        rt = ScenarioRuntime(cfg, **kw)
        if rt.device.type == "cuda" and not all(
                n.radio.device.type == "cuda" for n in rt.nodes if hasattr(n, "radio")):
            raise AssertionError("a radio node is off the card")
        t0 = time.perf_counter()
        summary = rt.run()
        wall = time.perf_counter() - t0
        if rt.failed_nodes:
            raise AssertionError(f"{cfg.name}: failed nodes {rt.failed_nodes}")
        return rt, summary, wall

    def intact(rt, idx):
        for i in idx:
            pk = rt.nodes[i].rx_packets
            if not pk:
                raise AssertionError(f"node {i} received no packet")
            for _, _, p in pk:
                if not np.array_equal(p[4:], known[4:]):
                    raise AssertionError(f"node {i}: a payload differs from the m-sequence")

    # 18. the two-node FDD link on the card, then its 0.25 s summary against the CPU run
    run(link_scenario_cfg(0.05))  # builds the receiver's and the tx chain's caches
    torch.cuda.synchronize()
    reset_counts()
    with HostBreakdown() as hb:
        rt, summary, wall = run(link_scenario_cfg(LINK_SCN_S))
    torch.cuda.synchronize()
    launches["link"] = ops.extract_windows.launches
    if launches["link"] < 1:
        raise AssertionError("the link scenario did not launch the extract kernel")
    intact(rt, (0, 1))
    steps = round(rt.t / rt.medium_cfg.block_dt)
    phase("scenario-link", f"{LINK_SCN_S} s on the card: packets {[len(n.rx_packets) for n in rt.nodes]} "
          f"each way, all equal to msequence_bytes(256)[4:]; summary {dataclasses.asdict(summary)}; "
          f"extract launches {launches['link']}, fused_sense_ct launches "
          f"{ops.fused_sense_ct.launches}; wall {wall:.3f} s, realtime factor "
          f"{LINK_SCN_S / wall:.4f} (steady {rt.steady_t / rt.steady_wall_time_s:.4f}); {smi}")
    phase("scenario-link", hb.line(steps, rt.wall_time_s) + f"; {smi}")
    n_ops, busy, idle = profile_steps(link_scenario_cfg(1.0))
    phase("scenario-link", f"profiled 40 steps: {n_ops:.1f} device operations and {busy:.1f} us "
          f"busy per step, device idle {idle:.1%} of the steps' host time; {smi}")
    _, on_card, _ = run(link_scenario_cfg(0.25))
    _, on_cpu, _ = run(link_scenario_cfg(0.25), device="cpu")
    if dataclasses.asdict(on_card) != dataclasses.asdict(on_cpu):
        raise AssertionError(f"link summary on the card {on_card} differs from the CPU run {on_cpu}")
    launches["link_summary"] = on_card
    phase("scenario-link", f"0.25 s: the card's ScenarioSummary equals the CPU run's "
          f"(valid frames {on_card.valid_frames}, bytes received {on_card.bytes_received})")

    # 19. scenarios/eight_node.cfg at its shipped widths
    cfg8 = load_scenario(ROOT / "scenarios" / "eight_node.cfg")
    cfg8.run_time = EIGHT_NODE_S
    reset_counts()
    with HostBreakdown() as hb:
        rt, summary, wall = run(cfg8)
    torch.cuda.synchronize()
    launches["eight_node"] = ops.extract_windows.launches
    launches["eight_node_summary"] = summary
    if launches["eight_node"] < 1:
        raise AssertionError("eight_node.cfg did not launch the extract kernel")
    intact(rt, range(6))
    steps = round(rt.t / rt.medium_cfg.block_dt)
    phase("scenario-eight-node", f"{EIGHT_NODE_S} s ({steps} steps of {cfg8.medium_block_len} at "
          f"{cfg8.medium_rate / 1e6:.0f} MS/s, rx_scan_blocks {cfg8.nodes[0].rx_scan_blocks}): "
          f"packets {[len(n.rx_packets) for n in rt.nodes[:6]]}, all intact; valid frames "
          f"{summary.valid_frames}; extract launches {launches['eight_node']}; wall {wall:.3f} s, "
          f"realtime factor {EIGHT_NODE_S / wall:.4f} (steady "
          f"{rt.steady_t / rt.steady_wall_time_s:.4f}); {smi}")
    phase("scenario-eight-node", hb.line(steps, rt.wall_time_s) + f"; {smi}")
    n_ops, busy, idle = profile_steps(load_scenario(ROOT / "scenarios" / "eight_node.cfg"))
    phase("scenario-eight-node", f"profiled 40 steps: {n_ops:.1f} device operations and "
          f"{busy:.1f} us busy per step, device idle {idle:.1%} of the steps' host time; {smi}")

    # 20. scenarios/predictive_model.cfg as bench.py:452-467 runs it
    scn = ROOT / "scenarios" / "predictive_model.cfg"
    wcfg = load_scenario(scn)
    wcfg.run_time = 0.5  # warm-up
    run(wcfg)
    scfg = load_scenario(scn)
    scfg.run_time = PREDICTIVE_S
    torch.cuda.synchronize()
    reset_counts()
    with HostBreakdown() as hb:
        rt, summary, wall = run(scfg)
    torch.cuda.synchronize()
    eng = rt.nodes[1].engine
    launches["predictive"] = ops.fused_sense_ct.launches
    launches["predictive_extract"] = ops.extract_windows.launches
    launches["predictive_viterbi"] = ops.viterbi_decode_k7.launches
    if not eng.decisions:
        raise AssertionError("the predictive SU made no decision")
    if launches["predictive"] != len(eng.decisions):
        raise AssertionError(f"{launches['predictive']} fused_sense_ct launches for "
                             f"{len(eng.decisions)} decisions: want one per decision")
    factor = rt.steady_t / rt.steady_wall_time_s
    steps = round(rt.t / rt.medium_cfg.block_dt)
    phase("scenario-predictive", f"{PREDICTIVE_S} s after a 0.5 s warm-up: {len(eng.decisions)} "
          f"decisions {dict(sorted(Counter(eng.decisions).items()))}, fused_sense_ct launches "
          f"{launches['predictive']} (one per decision), extract launches "
          f"{launches['predictive_extract']}, Viterbi launches "
          f"{launches['predictive_viterbi']}; bytes sent {summary.bytes_sent}; wall {wall:.3f} s; "
          f"scenario_realtime_factor = steady_t / steady_wall_time_s = {rt.steady_t:.4f} / "
          f"{rt.steady_wall_time_s:.4f} = {factor:.4f}; {smi}")
    phase("scenario-predictive", hb.line(steps, rt.wall_time_s) + f"; {smi}")
    n_ops, busy, idle = profile_steps(load_scenario(scn), warm=20, steps=60)
    phase("scenario-predictive", f"profiled 60 steps: {n_ops:.1f} device operations and "
          f"{busy:.1f} us busy per step, device idle {idle:.1%} of the steps' host time; {smi}")
    launches["predictive_factor"] = factor

    # the CE_TX_CHANNEL_X -c 1 variant: the SU finds CH1 busy and moves to 835 MHz
    vrt, _, _ = run(predictive_variant_cfg("-c 1"))
    dec = vrt.nodes[1].engine.decisions
    if not dec or Counter(dec).most_common(1)[0][0] != 1:
        raise AssertionError(f"CE_TX_CHANNEL_X -c 1: decisions {dec}")
    if vrt.nodes[1].radio.get_tx_freq() != 835e6:
        raise AssertionError(f"SU tx ends at {vrt.nodes[1].radio.get_tx_freq()}, not 835 MHz")
    # the same run on the CPU (plain versions): every decision equal, the MLP
    # outputs within the golden gate's atol 2e-3
    crt, _, _ = run(predictive_variant_cfg("-c 1"), device="cpu")
    cpu_eng = crt.nodes[1].engine
    if cpu_eng.decisions != dec:
        raise AssertionError(f"CE_TX_CHANNEL_X -c 1: card decisions {dec} differ from the CPU "
                             f"run's {cpu_eng.decisions}")
    out_card = torch.stack(vrt.nodes[1].engine.outputs).cpu()
    out_cpu = torch.stack(cpu_eng.outputs)
    torch.testing.assert_close(out_card, out_cpu, rtol=0.0, atol=2e-3)
    phase("scenario-predictive", f"CE_TX_CHANNEL_X -c 1: decisions {dec}, equal to the CPU run's; "
          f"MLP outputs max abs err {(out_card - out_cpu).abs().max().item():.3e} (atol 2e-3); "
          f"SU tx {vrt.nodes[1].radio.get_tx_freq() / 1e6:.0f} MHz")

    # one classify call of the SU's engine (upload, sense kernel, MLP, one read)
    buffers = [np.asarray(b) for b in eng.buffers] or [
        (np.random.default_rng(0).standard_normal(512) * 1e-3).astype(np.complex64)
        for _ in range(eng.cfg.averaging)]
    buffers = (buffers * eng.cfg.averaging)[: eng.cfg.averaging]

    def classify():
        eng.buffers = list(buffers)
        eng._classify_and_act()

    r = sense_profiled(classify, "classify")
    launches["path_calls"] = {"engine_classify": r}
    phase("sense-profile", f"one CEPredictiveNode classify (C=1: one upload, the classify kernel, "
          f"one .item()): {r['ms']:.4f} ms by host clock, {r['ops']} device operations, "
          f"{r['busy_us']:.1f} us busy ({r['kernel_us']:.1f} us the kernel), device idle "
          f"{r['idle']:.1%} (the profiler kept {r['kept']} calls); {smi}")

    # the sense path at C=4096, C=256 and the engine's C=1, device-resident
    # input and parameters: one device operation a call, two with the trace
    cfg = SenseConfig()
    fn, fn_trace = make_sense_fn(cfg), make_sense_fn(cfg, with_trace=True)
    params = reference_weights(device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for c in (CYCLES, CLI_CYCLES, 1):
        xr = torch.randn(c * cfg.averaging, cfg.fft_length, generator=gen, device="cuda")
        xi = torch.randn(c * cfg.averaging, cfg.fft_length, generator=gen, device="cuda")
        for label, call, most in ((f"sense_c{c}", lambda: fn((xr, xi), params), 1),
                                  (f"sense_trace_c{c}", lambda: fn_trace((xr, xi), params, 833e6), 2)):
            r = sense_profiled(call, label)
            launches["path_calls"][label] = r
            phase("sense-profile", f"make_sense_fn{' with_trace' if most == 2 else ''} C={c}: "
                  f"{r['ms']:.4f} ms per synchronized call by host clock, {r['ops']} device "
                  f"operations (at most {most}), {r['busy_us']:.1f} us busy, of which the sense "
                  f"kernels {r['kernel_us']:.1f} us ({r['kernel_us'] / r['busy_us']:.1%} of busy), "
                  f"device idle {r['idle']:.1%} (the profiler kept {r['kept']} calls); {smi}")
            if r["ops"] > most:
                raise AssertionError(f"{label}: {r['ops']} device operations a call, "
                                     f"more than {most}")
    return launches


def distributed_run(cfg, port: int, **kw):
    """``cfg`` through a ``NetController`` on the card: one node process per
    node.  Raises if a node died, stalled or sent no summary.  Returns the
    controller, its summary and the run's wall time."""
    from cognitive_radio_network_tpu_torch.runtime.netctl import NetController

    ctl = NetController(cfg, port=port, start_pad_s=1.0, device="cuda", **kw)
    t0 = time.perf_counter()
    summary = ctl.run()
    wall = time.perf_counter() - t0
    if ctl.terminated or sorted(ctl.summaries) != list(range(len(cfg.nodes))):
        raise AssertionError(f"{cfg.name} -d: terminated {ctl.terminated}, summaries from nodes "
                             f"{sorted(ctl.summaries)} of {len(cfg.nodes)}")
    return ctl, summary, wall


def node_lines(ctl, block_dt: float) -> str:
    """Per node: CPU ms per simulated step of the steady window, and the
    kernels it launched."""
    out = []
    for i, s in sorted(ctl.summaries.items()):
        steps = s["sim_time_s"] / block_dt
        used = {k: v for k, v in s["launches"].items() if v}
        out.append(f"node {i}: {s['cpu_time_s'] / steps * 1e3:.3f} CPU ms/step, launches {used}")
    return "; ".join(out)


def node_margin(ctl) -> float:
    """max_node_cpu_per_sim_s (bench.py:502-510): the busiest node's CPU
    seconds per simulated second of the steady window."""
    sums = ctl.summaries.values()
    return max(s["cpu_time_s"] for s in sums) / max(s["sim_time_s"] for s in sums)


def distributed_phases(smi: str, inproc: dict) -> dict:
    """Phases 21-23: the distributed runtime on the card, each node its own
    process.  Returns the kernels' launches in the node processes."""
    import dataclasses

    from cognitive_radio_network_tpu_torch.runtime import load_scenario

    launches = {}

    # 21. the two-node link of phase 18, distributed, against its in-process summary
    ctl, summary, wall = distributed_run(link_scenario_cfg(0.25), DIST_PORT, transport="native")
    if dataclasses.asdict(summary) != dataclasses.asdict(inproc["link_summary"]):
        raise AssertionError(f"distributed link summary {summary} differs from the in-process "
                             f"run's {inproc['link_summary']}")
    launches["link"] = [ctl.summaries[i]["launches"]["extract_windows"] for i in (0, 1)]
    if min(launches["link"]) < 1:
        raise AssertionError(f"link -d: a node launched no extract kernel ({launches['link']})")
    phase("distributed-link", f"0.25 s, 2 node processes on the card, native transport: the "
          f"summary equals phase 18's in-process one (valid frames {summary.valid_frames}); "
          f"extract launches per node {launches['link']}; wall {wall:.3f} s of which the "
          f"lockstep loop {ctl.wall_time_s:.3f}; {node_lines(ctl, ctl.mcfg.block_dt)}; {smi}")

    # 22. scenarios/eight_node.cfg -d at its shipped widths
    cfg8 = load_scenario(ROOT / "scenarios" / "eight_node.cfg")
    cfg8.run_time = DIST_EIGHT_NODE_S
    ctl, summary, wall = distributed_run(cfg8, DIST_PORT + 1)
    want = inproc["eight_node_summary"]
    if dataclasses.asdict(summary) != dataclasses.asdict(want):
        raise AssertionError(f"eight_node.cfg -d summary {summary} differs from phase 19's {want}")
    if min(summary.bytes_received[:6]) <= 0:
        raise AssertionError(f"eight_node.cfg -d: a radio received nothing {summary.bytes_received}")
    launches["eight_node"] = [ctl.summaries[i]["launches"]["extract_windows"] for i in range(8)]
    if min(launches["eight_node"][:6]) < 1:
        raise AssertionError(f"eight_node.cfg -d: a radio launched no extract kernel "
                             f"({launches['eight_node']})")
    factor = ctl.steady_t / ctl.steady_wall_time_s
    steps = round(ctl.t / ctl.mcfg.block_dt)
    phase("distributed-eight-node", f"{DIST_EIGHT_NODE_S} s ({steps} steps), 8 node processes "
          f"on one card, transport {ctl.tcls.__name__}: the summary equals phase 19's (bytes "
          f"received {summary.bytes_received}); distributed_realtime_factor_8node = steady_t / "
          f"steady_wall_time_s = {ctl.steady_t:.4f} / {ctl.steady_wall_time_s:.4f} = "
          f"{factor:.4f}; max_node_cpu_per_sim_s {node_margin(ctl):.4f}; controller wall "
          f"{ctl.wall_time_s / steps * 1e3:.3f} ms per step; wall {wall:.3f} s of which the "
          f"lockstep loop {ctl.wall_time_s:.3f}; extract launches per node "
          f"{launches['eight_node']}; {smi}")
    phase("distributed-eight-node", node_lines(ctl, ctl.mcfg.block_dt) + f"; {smi}")
    launches["eight_node_factor"], launches["eight_node_margin"] = factor, node_margin(ctl)

    # 23. scenarios/predictive_model.cfg -d: a warm run, then the timed one
    scn = ROOT / "scenarios" / "predictive_model.cfg"
    wcfg = load_scenario(scn)
    wcfg.run_time = DIST_PREDICTIVE_WARM_S
    _, _, warm_wall = distributed_run(wcfg, DIST_PORT + 2)
    dcfg = load_scenario(scn)
    dcfg.run_time = DIST_PREDICTIVE_S
    ctl, summary, wall = distributed_run(dcfg, DIST_PORT + 3)
    launches["predictive"] = ctl.summaries[1]["launches"]["fused_sense_ct"]
    if launches["predictive"] < 1:
        raise AssertionError("predictive_model.cfg -d: the SU's node launched no sense kernel")
    factor = ctl.steady_t / ctl.steady_wall_time_s
    phase("distributed-predictive", f"{DIST_PREDICTIVE_WARM_S} s warm run ({warm_wall:.3f} s "
          f"wall), then {DIST_PREDICTIVE_S} s: SU node fused_sense_ct launches "
          f"{launches['predictive']}; bytes sent {summary.bytes_sent}; "
          f"distributed_realtime_factor = steady_t / steady_wall_time_s = {ctl.steady_t:.4f} / "
          f"{ctl.steady_wall_time_s:.4f} = {factor:.4f}; max_node_cpu_per_sim_s "
          f"{node_margin(ctl):.4f}; wall {wall:.3f} s of which the lockstep loop "
          f"{ctl.wall_time_s:.3f}; {node_lines(ctl, ctl.mcfg.block_dt)}; {smi}")
    launches["predictive_factor"] = factor
    return launches


def wide_batch(dev):
    """The wideband train step's batch (phase 25) made on the card: ``APPLY_BATCH``
    streams of T=``APPLY_T`` at ``WidebandConfig()``, 0.01 noise plus a unit
    tone at the centre of each active channel (half of them, at random).
    Returns (planes (B, T*64, 2), labels (B, C, 64), active (B, 64))."""
    import numpy as np
    import torch

    m, bl = 64, 128
    cycles = APPLY_T // bl
    g = torch.Generator(device=dev).manual_seed(25)
    active = torch.rand(APPLY_BATCH, m, generator=g, device=dev) < 0.5
    phi = 2 * np.pi * torch.rand(APPLY_BATCH, m, 1, generator=g, device=dev, dtype=torch.float64)
    # a unit tone at channel k's centre repeats every M samples: one period per
    # stream, the sum over its active channels, tiled over T
    k = torch.arange(m, device=dev, dtype=torch.float64)
    ang = 2 * np.pi * k[:, None] * k[None, :] / m + phi  # (B, channel, n mod M)
    on = active[..., None].double()
    period = torch.stack([(on * ang.cos()).sum(1), (on * ang.sin()).sum(1)], dim=-1).float()
    batch = 0.01 * torch.randn(APPLY_BATCH, APPLY_T * m, 2, generator=g, device=dev)
    batch += period.repeat(1, APPLY_T, 1)
    labels = active.float()[:, None, :].expand(APPLY_BATCH, cycles, m).contiguous()
    return batch, labels, active


def training_phases(dev, smi: str) -> dict:
    """Phases 24-26: training at full width (the sense kernel in
    ``make_dataset`` and the evaluation), the wideband train step (the
    wideband kernel once per step for its batch), and the ``train`` and
    ``spectrum`` commands and GMSK on the card.  Returns the two kernels'
    launches on the training paths."""
    import copy
    import dataclasses
    import io
    import warnings
    from contextlib import redirect_stdout

    import numpy as np
    import torch

    from cognitive_radio_network_tpu_torch.__main__ import main as cli_main
    from cognitive_radio_network_tpu_torch.env import markov_pu_trace
    from cognitive_radio_network_tpu_torch.env.scene import occupancy_to_powers, synthesize_scene
    from cognitive_radio_network_tpu_torch.io.checkpoint import load_mlp_with_meta
    from cognitive_radio_network_tpu_torch.io.iq import IQWriter
    from cognitive_radio_network_tpu_torch.models import (
        SenseConfig,
        make_sense_fn,
        make_sharded_apply,
        make_sharded_train_step,
        wideband_features,
    )
    from cognitive_radio_network_tpu_torch.models.distributed import _loss
    from cognitive_radio_network_tpu_torch.models.train import (
        TrainConfig,
        TrainState,
        fit,
        make_dataset,
        make_optimizer,
        train_step,
    )
    from cognitive_radio_network_tpu_torch.ops import fused_sense_ct, wideband_energy_fused
    from cognitive_radio_network_tpu_torch.parallel import WidebandConfig, wideband_sense
    from cognitive_radio_network_tpu_torch.phy.gmsk import gmsk_frame
    from cognitive_radio_network_tpu_torch.signal.mlp import reference_weights
    from cognitive_radio_network_tpu_torch.utils.profiling import device_time

    launches = {}

    def gen(seed: int):
        return torch.Generator(device=dev).manual_seed(seed)

    # 24. training at the reference's own settings (tests/test_scenarios.py:186-193)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    feats, labels = make_dataset(gen(0), TRAIN_EXAMPLES, signal_power=0.005,
                                 power_jitter_decades=2.5)
    torch.cuda.synchronize()
    first_ds_s = time.perf_counter() - t0
    launches["make_dataset"] = fused_sense_ct.launches
    if launches["make_dataset"] != 1:
        raise AssertionError(f"make_dataset launched the sense kernel {launches['make_dataset']} "
                             f"times, not once")
    if tuple(feats.shape) != (TRAIN_EXAMPLES, 4) or not torch.isfinite(feats).all():
        raise AssertionError(f"make_dataset: features {tuple(feats.shape)} or non-finite values")
    tcfg = TrainConfig(num_steps=TRAIN_STEPS)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            params, losses = fit(gen(1), feats, labels, tcfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchronizing CUDA operation" in str(w.message)]
    # a synchronizing call inside the loop would warn once per step; fit reads
    # the losses back once, after it
    if len(syncs) > 1:
        raise AssertionError(f"{len(syncs)} synchronizing calls in fit's {TRAIN_STEPS} steps, "
                             f"e.g. {syncs[0].filename}:{syncs[0].lineno} {syncs[0].message}")
    where = f"{Path(syncs[0].filename).name}:{syncs[0].lineno}" if syncs else "none"
    if losses.shape != (TRAIN_STEPS,) or not np.isfinite(losses).all() or losses[-1] >= losses[0]:
        raise AssertionError(f"fit: losses {losses[:3]} .. {losses[-3:]} do not fall")
    ds_t = device_time(make_dataset, gen(0), TRAIN_EXAMPLES, SenseConfig(), None, 0.005, 2.5,
                       reps=5, warmup=1)
    fit_t = device_time(fit, gen(1), feats, labels, tcfg, reps=2, warmup=1)
    step_us = fit_t["mean_s"] / TRAIN_STEPS * 1e6
    probe = copy.deepcopy(params)  # profiled steps train a copy, not the net evaluated below
    state = TrainState(probe, make_optimizer(tcfg, probe), 0)
    _, ops, busy_us, _ = profiled(lambda: train_step(state, feats, labels, tcfg), "train_step", "")
    phase("training", f"make_dataset({TRAIN_EXAMPLES}, signal_power=0.005, "
          f"power_jitter_decades=2.5): 1 fused_sense_ct launch; {first_ds_s * 1e3:.1f} ms host "
          f"time (first call), then {ds_t['mean_s'] * 1e3:.3f} ms per call (device_time, 5 "
          f"calls); fit {TRAIN_STEPS} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"synchronizing calls {len(syncs)} (PyTorch's sync debug mode; where: {where}); "
          f"{fit_t['mean_s']:.3f} s per fit (device_time, 2 fits), "
          f"{TRAIN_STEPS / fit_t['mean_s']:.0f} steps/s, {step_us:.1f} us host time per step; profiled train_step: {ops:.1f} device "
          f"operations and {busy_us:.1f} us busy per step, so the device idles "
          f"{1 - busy_us / step_us:.1%} of a step of fit; {smi}")
    # the reference's criterion on a held-out Markov trace (tests/test_scenarios.py:195-231)
    cfg = SenseConfig()
    cfg_t = dataclasses.replace(cfg, feature_transform="log1p")
    sense, sense_t = make_sense_fn(cfg), make_sense_fn(cfg_t)
    ref_w = reference_weights(device=dev)
    trace = markov_pu_trace(gen(42), 256)
    truth = trace.cpu().numpy() + 1
    rows = []
    torch.cuda.synchronize()
    reset_counts()
    for power in (0.05, 5e-3, 5e-4, 2e-4, 1e-4):
        planes = synthesize_scene(gen(8), occupancy_to_powers(trace, 3, power=power),
                                  cfg.samples_per_cycle, as_planes=True)
        planar = tuple(planes[..., i].reshape(-1, cfg.fft_length).contiguous() for i in (0, 1))
        a_ref = float(np.mean(sense(planar, ref_w)["decision"].cpu().numpy() == truth))
        a_tr = float(np.mean(sense_t(planar, params)["decision"].cpu().numpy() == truth))
        rows.append((power, a_ref, a_tr))
    launches["evaluation"] = fused_sense_ct.launches
    table = ", ".join(f"{p:g}: reference {r:.4f}, trained {t:.4f}" for p, r, t in rows)
    phase("training", f"held-out 256-cycle Markov trace (generator seeds: dataset 0, start 1, "
          f"trace 42, scenes 8), accuracy by power: {table}; fused_sense_ct launches "
          f"{launches['evaluation']}")
    for p, r, t in rows:
        if t < r - 1e-9:
            raise AssertionError(f"at power {p:g} the trained net ({t:.4f}) is below the "
                                 f"reference weights ({r:.4f})")
    if not (rows[-1][2] >= 0.95 and rows[-1][1] <= 0.9):
        raise AssertionError(f"at power 1e-4: trained {rows[-1][2]:.4f} (needs >= 0.95), "
                             f"reference {rows[-1][1]:.4f} (needs <= 0.9)")
    if launches["evaluation"] != 2 * len(rows):
        raise AssertionError(f"the evaluation launched the sense kernel {launches['evaluation']} "
                             f"times for {2 * len(rows)} calls")
    del feats, labels

    # 25. the wideband train step at full width on phase 11's batch shape
    wcfg = WidebandConfig()
    m = wcfg.num_channels
    batch, wlabels, active = wide_batch(dev)
    init_fn, step_fn = make_sharded_train_step(wcfg, learning_rate=3e-2)
    wstate = init_fn(gen(0))
    with torch.no_grad():
        res = wideband_sense(batch, torch.from_numpy(wcfg.taps()).to(dev), wcfg, use_fused=False)
        packed_loss = _loss(wstate.params, wideband_features(res["energy"], res["noise"]), wlabels)
    del res
    torch.cuda.synchronize()
    reset_counts()
    wlosses, per_step = [], []
    for _ in range(WIDE_TRAIN_STEPS):
        before = wideband_energy_fused.launches
        wstate, loss = step_fn(wstate, batch, wlabels)
        per_step.append(wideband_energy_fused.launches - before)
        wlosses.append(loss)
    wlosses = torch.stack(wlosses).cpu().numpy()
    launches["train_steps"] = wideband_energy_fused.launches
    if set(per_step) != {1}:
        raise AssertionError(f"a train step launched the wideband kernel {sorted(set(per_step))} "
                             f"times, not once for its batch")
    rel = abs(float(wlosses[0]) - packed_loss.item()) / packed_loss.item()
    if rel > 1e-5:
        raise AssertionError(f"first step's loss {wlosses[0]} differs from the packed path's "
                             f"{packed_loss.item()} by rtol {rel:.2e}")
    if not (wlosses[-1] < 0.5 * wlosses[0] and wlosses[-1] < 0.2):
        raise AssertionError(f"wideband training: loss {wlosses[0]:.4f} -> {wlosses[-1]:.4f}")
    probs = make_sharded_apply(wcfg)(wstate.params, batch)
    acc = float(((probs > 0.5) == (wlabels > 0.5)).float().mean())
    if acc <= 0.95:
        raise AssertionError(f"wideband training: apply accuracy {acc:.4f}")
    wt = device_time(step_fn, wstate, batch, wlabels, reps=20, warmup=2)
    wall_ms, ops, busy_us, kern_us = profiled(lambda: step_fn(wstate, batch, wlabels),
                                              "wideband_step", "fused_wideband_kernel")
    phase("wideband-training", f"WidebandConfig() on ({APPLY_BATCH}, {APPLY_T * m}, 2) planes, "
          f"{int(active.sum())} active channel-streams, {WIDE_TRAIN_STEPS} steps at lr 3e-2: "
          f"1 wideband kernel launch in every step for its {APPLY_BATCH} streams "
          f"({launches['train_steps']} in "
          f"all); first loss {wlosses[0]:.6f}, packed plain path {packed_loss.item():.6f} (rel "
          f"{rel:.2e}, rtol 1e-5); loss {wlosses[0]:.4f} -> {wlosses[-1]:.4f}; make_sharded_apply "
          f"accuracy {acc:.4f}; {wt['mean_s'] * 1e3:.4f} ms per step (device_time, 20 steps "
          f"back to back); one synchronized step {wall_ms:.4f} ms by host clock, {ops:.1f} "
          f"device operations, {busy_us:.1f} us busy, the kernel {kern_us:.1f} us "
          f"({kern_us / busy_us:.1%} of busy); {smi}")
    del batch, probs

    # 26. the surface: the train and spectrum commands on the card, GMSK
    work = ROOT / "build" / "chip_smoke_training"
    work.mkdir(parents=True, exist_ok=True)
    try:
        ckpt = work / "mlp.npz"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "cognitive_radio_network_tpu_torch", "train", "-o", str(ckpt)],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
        )
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"train CLI exited {proc.returncode}:\n{proc.stdout}{proc.stderr}")
        mlp, meta = load_mlp_with_meta(ckpt, device=dev)
        if meta["feature_transform"] != "log1p" or tuple(mlp.w1.shape) != (4, 5):
            raise AssertionError(f"train CLI checkpoint: {meta}, w1 {tuple(mlp.w1.shape)}")
        phase("surface", f"python -m cognitive_radio_network_tpu_torch train (the card, defaults) "
              f"in {cli_s:.1f} s (process included): {proc.stdout.strip().splitlines()[-1]}; "
              f"load_mlp_with_meta reads it: feature_transform {meta['feature_transform']}")
        # a PU parked on CH2 (835 MHz), made on the card, through the spectrum command
        powers = occupancy_to_powers(torch.full((16,), 1, device=dev), 3, power=0.1)
        planes = synthesize_scene(gen(26), powers, 1024 * 8, as_planes=True)
        cap, wf_out = work / "capture.iq", work / "wf.npz"
        with IQWriter(cap, 13e6, 833e6) as w:
            w.write(planes.reshape(-1, 2).cpu().numpy())
        shown = io.StringIO()
        with redirect_stdout(shown):
            rc = cli_main(["spectrum", str(cap), "--out", str(wf_out)])
        with np.load(wf_out) as d:
            wf, f = d["waterfall_db"], d["freq_hz"]
        peak = float(f[(10 ** (wf / 10)).mean(0).argmax()])
        if rc != 0 or wf.shape != (16, 1024) or not np.isfinite(wf).all():
            raise AssertionError(f"spectrum: rc {rc}, waterfall {wf.shape}")
        if abs(peak - 835e6) > 0.7e6:
            raise AssertionError(f"spectrum: the peak at {peak / 1e6:.3f} MHz is not in CH2")
        phase("surface", f"spectrum (the card) on a 16-row capture of a PU on CH2: waterfall "
              f"{wf.shape}, peak at {peak / 1e6:.3f} MHz (CH2 835 +- 0.7); "
              f"{shown.getvalue().strip().splitlines()[-1]}")
        on_card = gmsk_frame(np.random.default_rng(26), device=dev)
        on_cpu = gmsk_frame(np.random.default_rng(26), device="cpu")
        diff = (on_card.cpu() - on_cpu).abs().max().item()
        if on_card.device.type != "cuda" or on_card.shape != on_cpu.shape or diff > 1e-6:
            raise AssertionError(f"gmsk_frame on the card differs from the CPU by {diff:.2e}")
        phase("surface", f"gmsk_frame on the card: {tuple(on_card.shape)} complex64, within "
              f"atol 1e-6 of the CPU's (max abs diff {diff:.2e}, equal bits: "
              f"{torch.equal(on_card.cpu(), on_cpu)})")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


def host_ms(fn, reps: int) -> float:
    """Median host ms of ``reps`` synchronized calls."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def wideband_rank(d: int, device: str) -> dict:
    """Phase 27 on one of ``d`` ranks sharing the card: the fused sharded
    energy at full width against kernel 3 on the whole stream."""
    import torch
    import torch.distributed as dist

    from cognitive_radio_network_tpu_torch.ops import wideband_energy_fused
    from cognitive_radio_network_tpu_torch.parallel import MeshSpec, WidebandConfig, make_mesh
    from cognitive_radio_network_tpu_torch.parallel import make_wideband_fn
    from cognitive_radio_network_tpu_torch.parallel.collectives import all_gather
    from cognitive_radio_network_tpu_torch.parallel.mesh import block_range
    from cognitive_radio_network_tpu_torch.parallel.wideband import sharded_wideband_energy_fused

    mesh = make_mesh(MeshSpec(time=d), device=device)
    dev = torch.empty(0, device=device).device  # "cuda": the rank's card
    cfg = WidebandConfig()
    g = torch.Generator(device=dev).manual_seed(27)
    xr = torch.randn(WIDE_T * 64, generator=g, device=dev)
    xi = torch.randn(WIDE_T * 64, generator=g, device=dev)
    taps = torch.from_numpy(cfg.taps()).to(dev)
    whole = wideband_energy_fused(xr, xi, taps, cfg)  # one device: the reference of the phase
    torch.cuda.synchronize()
    dist.barrier()
    reset_counts()
    got = sharded_wideband_energy_fused(xr, xi, mesh, cfg)
    launches = wideband_energy_fused.launches
    lo, hi = block_range(WIDE_T // cfg.block_len, mesh, "time")
    fn_out = make_wideband_fn(cfg, mesh=mesh, device=dev)((xr, xi))
    fn_launches = wideband_energy_fused.launches - launches
    equal = (torch.equal(got, whole[lo:hi]) and torch.equal(all_gather(got, mesh, "time"), whole)
             and torch.equal(fn_out["energy"], whole[lo:hi]))
    dist.barrier()
    ms = statistics.median(time_ms(lambda: sharded_wideband_energy_fused(xr, xi, mesh, cfg), [()]))
    dist.barrier()
    wall = host_ms(lambda: sharded_wideband_energy_fused(xr, xi, mesh, cfg), 10)
    # the kernel alone on this rank's segment, the others' running beside it
    seg = slice(lo * cfg.block_len * 64, hi * cfg.block_len * 64)
    dist.barrier()
    kern = statistics.median(time_ms(lambda: wideband_energy_fused(xr[seg], xi[seg], taps, cfg), [()]))
    return {"equal": equal, "launches": launches, "fn_launches": fn_launches, "ms": ms,
            "host_ms": wall, "kernel_ms": kern, "cycles": hi - lo,
            "backend": dist.get_backend(), "world": dist.get_world_size()}


def link_rank(device: str) -> dict:
    """Phase 28 on one of 2 ranks: the sharded fixed-config receiver on the
    link block, then the sharded streaming receiver's ``receive_device`` on
    the adaptive stream, each against its one-device receiver."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import cognitive_radio_network_tpu_torch.parallel.phylink as phylink
    from cognitive_radio_network_tpu_torch.graft_entry import _frames
    from cognitive_radio_network_tpu_torch.ops import extract_windows
    from cognitive_radio_network_tpu_torch.parallel import MeshSpec, make_mesh
    from cognitive_radio_network_tpu_torch.phy import OFDMFrameConfig, OFDMFrameSync, StreamReceiver

    mesh = make_mesh(MeshSpec(time=2), device=device)
    dev = torch.empty(0, device=device).device  # "cuda": the rank's card
    cfg = OFDMFrameConfig()
    out = {"backend": dist.get_backend(), "world": dist.get_world_size()}

    lr, li, _, _, _ = link_block(dev, np.random.default_rng(0))
    one = _frames(
        OFDMFrameSync(cfg, LINK_PAYLOAD, device=dev).receive_block((lr, li), k=LINK_FRAMES))
    rx = phylink.ShardedFrameReceiver(cfg, LINK_PAYLOAD, mesh, k_per_shard=LINK_FRAMES, device=dev)
    torch.cuda.synchronize()
    dist.barrier()
    reset_counts()
    frames = _frames(rx.receive((lr, li)))
    out["link_launches"] = extract_windows.launches
    out["link_frames"] = len(frames)
    out["link_equal"] = frames == one and len(one) == LINK_FRAMES and all(f[4] for f in frames)
    dist.barrier()
    out["link_ms"] = host_ms(lambda: rx.receive((lr, li)), 5)

    blocks, _, pays, _ = adaptive_blocks(dev)
    one_rx = StreamReceiver(cfg, max_frames_per_block=STREAM_FRAMES // STREAM_BLOCKS + 8, device=dev)
    t0 = time.perf_counter()
    one = sum((_frames(one_rx.process(b)) for b in blocks), [])
    out["one_pass_s"] = time.perf_counter() - t0
    moved = []  # samples receive_device copied from the host to the card
    place = phylink._place

    def spy(x, to):
        if x.device.type != torch.device(to).type:
            moved.append(x.shape[0])
        return place(x, to)

    srx = phylink.ShardedStreamReceiver(cfg, mesh, k_per_shard=SHARD_STREAM_K, device=dev)
    torch.cuda.synchronize()
    dist.barrier()
    reset_counts()
    phylink._place = spy
    try:
        t0 = time.perf_counter()
        sframes = sum((_frames(srx.receive_device(*b)) for b in blocks), [])
        torch.cuda.synchronize()
        out["stream_pass_s"] = time.perf_counter() - t0
    finally:
        phylink._place = place
    out["stream_launches"] = extract_windows.launches
    out["stream_frames"] = len(sframes)
    out["stream_moved"] = sum(moved)
    out["stream_equal"] = (sframes == one and len(one) == STREAM_FRAMES
                           and [f[2] for f in sframes] == [bytes(p) for p in pays])
    dist.barrier()
    t0 = time.perf_counter()
    again = sum((len(srx.receive_device(*b)) for b in blocks), 0)
    out["stream_pass2_s"] = time.perf_counter() - t0
    out["stream_frames2"] = again
    t0 = time.perf_counter()
    sum((len(one_rx.process(b)) for b in blocks), 0)
    out["one_pass2_s"] = time.perf_counter() - t0
    out["cfgs"] = sorted({f[5] for f in sframes})
    return out


def train_rank(specs: tuple, device: str) -> dict:
    """Phase 29 on one rank: 20 sharded wideband train steps at full width on
    each mesh of ``specs`` (time, channel, data), from the parameters of
    ``init_fn`` (the mesh's first rank's), against the one-device step from
    the same parameters."""
    import copy

    import torch
    import torch.distributed as dist

    from cognitive_radio_network_tpu_torch.models.distributed import make_sharded_train_step
    from cognitive_radio_network_tpu_torch.models.train import TrainConfig, TrainState, make_optimizer
    from cognitive_radio_network_tpu_torch.ops import wideband_energy_fused
    from cognitive_radio_network_tpu_torch.parallel import MeshSpec, WidebandConfig, make_mesh

    dev = torch.empty(0, device=device).device  # "cuda": the rank's card
    batch, labels, _ = wide_batch(dev)
    wcfg = WidebandConfig()
    out = {"backend": dist.get_backend(), "world": dist.get_world_size()}
    for spec in specs:
        mesh = make_mesh(MeshSpec(*spec), device=device)
        init_fn, step_fn = make_sharded_train_step(wcfg, learning_rate=3e-2, mesh=mesh, device=dev)
        state = init_fn(torch.Generator(device=dev).manual_seed(dist.get_rank()))
        params = copy.deepcopy(state.params)
        one = TrainState(params, make_optimizer(TrainConfig(3e-2), params), 0)
        _, one_step = make_sharded_train_step(wcfg, learning_rate=3e-2, device=dev)
        want = []
        for _ in range(WIDE_COMPARED_STEPS):
            one, loss = one_step(one, batch, labels)
            want.append(loss)
        torch.cuda.synchronize()
        dist.barrier()
        reset_counts()
        t0 = time.perf_counter()
        got = []
        for _ in range(WIDE_COMPARED_STEPS):
            state, loss = step_fn(state, batch, labels)
            got.append(loss)
        got = torch.stack(got).cpu().tolist()
        step_ms = (time.perf_counter() - t0) / WIDE_COMPARED_STEPS * 1e3
        want = torch.stack(want).cpu().tolist()
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        out[spec] = {"losses": got, "one_device": want, "rel": rel, "step_ms": step_ms,
                     "launches": wideband_energy_fused.launches}
    return out


def sharded_phases(smi: str) -> dict:
    """Phases 27-30: the multi-device layer on the card, N ranks sharing it
    through ``gloo`` (NCCL takes one card per rank; the world of one runs
    NCCL).  Returns the sharded launches of kernels 2 and 3."""
    from cognitive_radio_network_tpu_torch.graft_entry import dryrun_multichip
    from cognitive_radio_network_tpu_torch.parallel.launch import run_ranks

    launches = {"wideband": {}, "extract": {}}

    # 27. the fused sharded wideband energy at full width, time=2 and time=4
    for d in (2, 4):
        t0 = time.perf_counter()
        res = run_ranks(wideband_rank, d, backend="gloo", args=(d, "cuda"), timeout_s=600)
        wall = time.perf_counter() - t0
        r0 = res[0]
        if not all(r["equal"] for r in res):
            raise AssertionError(f"time={d}: the sharded energies are not torch.equal to kernel 3 "
                                 f"on the whole stream")
        if [r["launches"] for r in res] != [1] * d or [r["fn_launches"] for r in res] != [1] * d:
            raise AssertionError(f"time={d}: kernel 3 launches per rank "
                                 f"{[r['launches'] for r in res]}, not 1 each")
        launches["wideband"][f"sharded_wideband_energy_fused time={d}, per rank"] = \
            [r["launches"] for r in res]
        n_wide = WIDE_T * 64
        b_ms, b_by = bound(2 * n_wide // d * 4 + r0["cycles"] * 64 * 4 + 2 * 4 * 128 * 4, 0)
        per_rank = {k: ", ".join(f"{r[k]:.4f}" for r in res) for k in ("ms", "host_ms", "kernel_ms")}
        phase("sharded-wideband", f"backend={r0['backend']} world={r0['world']} time={d}: "
              f"sharded_wideband_energy_fused at T={WIDE_T} ({n_wide / 1e6:.1f} M wide "
              f"samples): every rank's {r0['cycles']} cycles and the gathered whole torch.equal "
              f"to kernel 3 on the whole stream, make_wideband_fn(cfg, mesh=) too; kernel 3 "
              f"launches per rank {[r['launches'] for r in res]}; per call, ranks side by side: "
              f"{per_rank['ms']} ms by CUDA events back to back, {per_rank['host_ms']} ms host "
              f"time per synchronized call, the kernel alone on a rank's segment "
              f"{per_rank['kernel_ms']} ms (bound {b_ms:.4f} ms by {b_by}); halo 4 KB per call "
              f"by one ring shift through the host; {wall:.1f} s with the ranks' start; {smi}")

    # 28. the sharded receivers, time=2
    t0 = time.perf_counter()
    (r0, r1) = run_ranks(link_rank, 2, backend="gloo", args=("cuda",), timeout_s=900)
    wall = time.perf_counter() - t0
    for r in (r0, r1):
        if not (r["link_equal"] and r["stream_equal"]):
            raise AssertionError(f"sharded receivers: link {r['link_frames']}/{LINK_FRAMES} "
                                 f"equal {r['link_equal']}, stream {r['stream_frames']}/"
                                 f"{STREAM_FRAMES} equal {r['stream_equal']}")
        if r["stream_frames2"] != STREAM_FRAMES or r["stream_moved"]:
            raise AssertionError(f"second pass {r['stream_frames2']} frames; receive_device "
                                 f"copied {r['stream_moved']} samples from the host")
        if r["link_launches"] < 2 or r["stream_launches"] < 2 * STREAM_BLOCKS:
            raise AssertionError(f"extract launches per rank: link {r['link_launches']}, "
                                 f"stream {r['stream_launches']}")
    launches["extract"]["ShardedFrameReceiver.receive, per rank"] = \
        [r0["link_launches"], r1["link_launches"]]
    launches["extract"]["ShardedStreamReceiver.receive_device pass of 4 blocks, per rank"] = \
        [r0["stream_launches"], r1["stream_launches"]]
    phase("sharded-link", f"backend={r0['backend']} world={r0['world']} time=2: "
          f"ShardedFrameReceiver(k_per_shard={LINK_FRAMES}) on the link block: "
          f"{r0['link_frames']}/{LINK_FRAMES} frames, byte-equal to receive_block(k="
          f"{LINK_FRAMES}) on one device; extract launches per rank "
          f"{[r0['link_launches'], r1['link_launches']]}; {r0['link_ms']:.3f}, "
          f"{r1['link_ms']:.3f} ms host time per synchronized call; {smi}")
    phase("sharded-link", f"backend={r0['backend']} world={r0['world']} time=2: "
          f"ShardedStreamReceiver(k_per_shard={SHARD_STREAM_K}).receive_device on the adaptive "
          f"stream ({STREAM_BLOCKS} blocks): {r0['stream_frames']}/{STREAM_FRAMES} frames "
          f"({', '.join(r0['cfgs'])}), byte-equal to StreamReceiver.process on one device, "
          f"payloads equal to those sent, {r0['stream_moved']} samples copied from the host; "
          f"extract launches per rank {[r0['stream_launches'], r1['stream_launches']]}; a pass "
          f"{r0['stream_pass_s']:.3f} s (first), {r0['stream_pass2_s']:.3f} s (second, "
          f"{STREAM_FRAMES / r0['stream_pass2_s']:.0f} frames/s), one device's process "
          f"{r0['one_pass_s']:.3f} s (first), {r0['one_pass2_s']:.3f} s (second) by host clock "
          f"on rank 0; {wall:.1f} s with the ranks' start; {smi}")

    # 29. the sharded train step at full width, data=2 and time=2; NCCL's world of one
    specs = ((1, 1, 2), (2, 1, 1))
    t0 = time.perf_counter()
    res = run_ranks(train_rank, 2, backend="gloo", args=(specs, "cuda"), timeout_s=900)
    res += run_ranks(train_rank, 1, backend="nccl", args=(((1, 1, 1),), "cuda"), timeout_s=600)
    wall = time.perf_counter() - t0
    for r in res:
        for spec in (s for s in r if isinstance(s, tuple)):
            if r[spec]["rel"] > 1e-5:
                raise AssertionError(f"backend={r['backend']} mesh {spec}: losses part from the "
                                     f"one-device step's by rtol {r[spec]['rel']:.2e}")
    names = {(1, 1, 2): "data=2", (2, 1, 1): "time=2", (1, 1, 1): "world of one"}
    for r in res:  # one launch per rank per step, whatever the rank's streams
        for spec in (s for s in r if isinstance(s, tuple)):
            if r[spec]["launches"] != WIDE_COMPARED_STEPS:
                raise AssertionError(f"{names[spec]}: {r[spec]['launches']} kernel 3 launches "
                                     f"in {WIDE_COMPARED_STEPS} steps")
    for r in (res[0], res[-1]):  # rank 0 of each world
        for spec in (s for s in r if isinstance(s, tuple)):
            v = r[spec]
            launches["wideband"][f"train step {names[spec]}, per rank per step"] = \
                v["launches"] // WIDE_COMPARED_STEPS
            phase("sharded-training", f"backend={r['backend']} world={r['world']} "
                  f"{names[spec]}: {WIDE_COMPARED_STEPS} sharded steps at WidebandConfig() on "
                  f"({APPLY_BATCH}, {APPLY_T * 64}, 2) from init_fn's broadcast parameters: "
                  f"loss {v['losses'][0]:.6f} -> {v['losses'][-1]:.6f}, one device "
                  f"{v['one_device'][0]:.6f} -> {v['one_device'][-1]:.6f}, max rel diff "
                  f"{v['rel']:.2e} (rtol 1e-5); {v['launches'] // WIDE_COMPARED_STEPS} kernel 3 "
                  f"launches per step per rank; {v['step_ms']:.3f} ms per step by host clock; "
                  f"{smi}")
    phase("sharded-training", f"phase 29 in {wall:.1f} s with the ranks' start")

    # 30. the port's dry run on 2 and 4 ranks, numerics held to one device
    for n in (2, 4):
        t0 = time.perf_counter()
        out = dryrun_multichip(n, backend="gloo")
        phase("dryrun", f"backend=gloo world={n}: dryrun_multichip({n}) passed in "
              f"{time.perf_counter() - t0:.1f} s: mesh {out['mesh']}, loss {out['loss']:.6f} "
              f"(one device {out['one_device_loss']:.6f}, rtol 1e-5), fixed-config frames "
              f"{out['phylink_frames']}/{out['placed']} and streaming frames "
              f"{out['adaptive_frames']}/{out['placed']} byte-equal to one device's; {smi}")
    return launches


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

    from cognitive_radio_network_tpu_torch import native
    from cognitive_radio_network_tpu_torch.env import markov_pu_trace
    from cognitive_radio_network_tpu_torch.env.scene import occupancy_to_powers, synthesize_scene
    from cognitive_radio_network_tpu_torch.io.iq import IQWriter
    from cognitive_radio_network_tpu_torch.models import (
        SenseConfig,
        make_sense_fn,
        sense_classify_trace,
    )
    from cognitive_radio_network_tpu_torch.ops import _build
    from cognitive_radio_network_tpu_torch.ops.extract import extract_windows
    from cognitive_radio_network_tpu_torch.ops.fused_sense_ct import (
        fused_sense_classify,
        fused_sense_classify_plain,
        fused_sense_ct,
        fused_sense_ct_plain,
        sense_trace,
        sense_trace_plain,
    )
    from cognitive_radio_network_tpu_torch.signal.detector import occupancy_decision
    from cognitive_radio_network_tpu_torch.profile_sense import measure_kernels
    from cognitive_radio_network_tpu_torch.signal.mlp import init_mlp, mlp_apply, reference_weights

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
            if "Compiling entry function" in line:
                phase("build", f"{kernel_of(line)}:")
            elif "registers" in line or "spill" in line:
                phase("build", line.strip())
    _build.load()
    phase("build", f"{lib_path.relative_to(ROOT)} ready in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native runtime library did not build or load")
    phase("build", f"native runtime library {native.library_path().relative_to(ROOT)} loaded "
          f"in {time.perf_counter() - t0:.1f} s")

    # 2. kernel vs plain on the card
    gen = torch.Generator(device=dev).manual_seed(0)

    def planes(c: int):
        return (
            torch.randn(c * a, n, generator=gen, device=dev),
            torch.randn(c * a, n, generator=gen, device=dev),
        )

    def engine_planes():
        # the predictive engine's own C=1 input: ten complex buffers stacked on
        # the host, one upload, the kernel given two views of it
        # (engines/predictive_node.py::_classify_and_act)
        rng = np.random.default_rng(1)
        stack = (rng.standard_normal((a, n)) + 1j * rng.standard_normal((a, n))).astype(np.complex64)
        both = torch.from_numpy(np.stack([stack.real, stack.imag]).astype(np.float32)).to(dev)
        return both[0], both[1]

    max_abs_err = 0.0
    for c, make in ((CYCLES, lambda: planes(CYCLES)), (5, lambda: planes(5)), (1, engine_planes)):
        xr, xi = make()
        avg_k, feats_k = fused_sense_ct(xr, xi, averaging=a)
        avg_p, feats_p = fused_sense_ct_plain(xr, xi, averaging=a)
        torch.cuda.synchronize()
        torch.testing.assert_close(avg_k, avg_p, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(feats_k, feats_p, rtol=1e-4, atol=0.0)
        err = (avg_k - avg_p).abs().max().item()
        max_abs_err = max(max_abs_err, err)
        frel = ((feats_k - feats_p).abs() / feats_p.abs()).max().item()
        what = " (views of one (2, 10, 512) upload, as the engine gives them)" if c == 1 else ""
        phase("kernel-vs-plain", f"f32 C={c}{what}: avg max abs err {err:.3e} (rtol 1e-4, atol 1e-5), "
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

    # the classify form: the same walk with the MLP and the decision per cycle
    ref_w = tuple(p.detach() for p in reference_weights(device=dev).parameters())
    seeded = init_mlp(torch.Generator(device=dev).manual_seed(4), 4, 7, 3)
    with torch.no_grad():
        seeded.b1.uniform_(-1, 1, generator=gen)
        seeded.b2.uniform_(-1, 1, generator=gen)
    seeded_w = tuple(p.detach() for p in seeded.parameters())
    tail_err = 0.0
    for c, make in ((CYCLES, lambda: planes(CYCLES)), (5, lambda: planes(5)), (1, engine_planes)):
        xr, xi = make()
        for what, w, log1p, thr, scale in (("reference weights", ref_w, False, 0.8, 1.0),
                                           ("seeded 4-7-3 on log1p", seeded_w, True, 0.5, 0.01)):
            x = (scale * xr, scale * xi)
            avg_k, feats_k, outs_k, dec_k = fused_sense_classify(*x, *w, log1p=log1p, threshold=thr)
            avg_c, feats_c = fused_sense_ct(*x)
            plain = fused_sense_classify_plain(*x, *w, log1p=log1p, threshold=thr)
            own = mlp_apply(torch.log1p(feats_k) if log1p else feats_k, *w)
            torch.cuda.synchronize()
            if not (torch.equal(avg_k, avg_c) and torch.equal(feats_k, feats_c)):
                raise AssertionError(f"classify C={c}: spectrum or features differ from "
                                     f"fused_sense_ct's")
            torch.testing.assert_close(outs_k, own, rtol=0.0, atol=1e-5)
            torch.testing.assert_close(outs_k, plain[2], rtol=0.0, atol=2e-3)
            if not torch.equal(dec_k, occupancy_decision(outs_k, thr)):
                raise AssertionError(f"classify C={c}: decisions differ from the rule on its outputs")
            near = ((plain[2] - thr).abs() < 2e-3).any(dim=1)
            if not torch.equal(dec_k[~near], plain[3][~near]):
                raise AssertionError(f"classify C={c}: decisions differ from the plain chain's")
            e_own = (outs_k - own).abs().max().item()
            e_plain = (outs_k - plain[2]).abs().max().item()
            tail_err = max(tail_err, e_plain)
            phase("kernel-vs-plain", f"classify f32 C={c}, {what}, threshold {thr}: avg and feats "
                  f"torch.equal to fused_sense_ct's; outputs max abs err {e_own:.3e} vs the MLP on "
                  f"its features (atol 1e-5), {e_plain:.3e} vs the plain chain (atol 2e-3); "
                  f"decisions equal ({int(near.sum())} cycles within 2e-3 of the threshold)")
    rand_dec = torch.randint(0, 4, (CYCLES,), generator=gen, device=dev, dtype=torch.int32)
    rand_dec[torch.rand(CYCLES, generator=gen, device=dev) < 0.5] = 0
    for tx0 in (833e6, torch.tensor(838e6, device=dev)):
        if not torch.equal(sense_trace(rand_dec, tx0), sense_trace_plain(rand_dec, tx0)):
            raise AssertionError(f"sense_trace differs from its plain version (tx0 {tx0!r})")
    phase("kernel-vs-plain", f"sense_trace C={CYCLES} on random decisions, tx0 a float and a 0-d "
          f"tensor on the card: torch.equal to the plain version")

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
    # numpy planes: the function moves host input to the card, its default device
    reset_counts()
    g_out = fn((g_np[..., 0].reshape(-1, n).copy(), g_np[..., 1].reshape(-1, n).copy()), params)
    if g_out["decision"].device.type != "cuda":
        raise AssertionError("make_sense_fn sensed host input off the card")
    if fused_sense_ct.launches != 1:
        raise AssertionError(f"the golden gate made {fused_sense_ct.launches} classify launches")
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
    reset_counts()
    t0 = time.perf_counter()
    res, freqs = sense_classify_trace(planar, params, 833e6, cfg)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches, trace_launches = fused_sense_ct.launches, sense_trace.launches
    if (launches, trace_launches) != (1, 1):
        raise AssertionError(f"the main path made {launches} classify and {trace_launches} trace "
                             f"launches, not 1 and 1")
    plain = fused_sense_classify_plain(*planar, *(p.detach() for p in params.parameters()),
                                       tx0=833e6)
    torch.cuda.synchronize()
    if not (torch.equal(res["decision"], plain[3]) and torch.equal(freqs, plain[4])):
        raise AssertionError("main path: decisions or trace differ from fused_sense_classify_plain")
    torch.testing.assert_close(res["outputs"], plain[2], rtol=0.0, atol=2e-3)
    main_err = (res["outputs"] - plain[2]).abs().max().item()
    tail_err = max(tail_err, main_err)
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
          f"in {main_s * 1e3:.1f} ms host time; classify launches {launches}, trace launches "
          f"{trace_launches}; decisions and trace torch.equal to fused_sense_classify_plain's, "
          f"outputs max abs err {main_err:.3e} (atol 2e-3); decision == PU+1 on "
          f"{hit:.4f}; tx trace follows policy (final {want[-1] / 1e6:.0f} MHz); extract "
          f"launches {extract_windows.launches}")

    # 5. the CLI at its default dispatch size
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    cap, out = work / "capture.iq", work / "out.npz"
    try:
        with IQWriter(cap, cfg.sample_rate_hz, cfg.center_hz) as w:
            w.write(scene.reshape(-1, 2).cpu().numpy())
        del scene
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
        if "through the native prefetcher" not in proc.stdout:
            raise AssertionError(f"the sense CLI did not ingest through the native prefetcher: "
                                 f"{proc.stdout}")
        phase("cli", f"{len(cli_dec)} decisions, equal to the main path's, in {cli_s:.1f} s "
              f"(process included): {proc.stdout.strip().splitlines()[0]}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # 6. times
    times, tail = {}, {}
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
        b_ms, by = sense_bound(c, a, n, 4)
        gbs = c * a * n * 8 / (k_ms * 1e-3) / 1e9
        phase("time", f"C={c} f32 ({bufs} input sets): kernel {k_ms:.4f} ms/dispatch "
              f"({msps / k_ms:.0f} MS/s, {gbs:.0f} GB/s read, {gbs / 3350:.1%} of 3.35 TB/s; "
              f"bound {b_ms:.4f} ms by {by}, so {k_ms / b_ms:.2f}x its bound), plain {p_ms:.4f} "
              f"ms/dispatch ({msps / p_ms:.0f} MS/s), median of 3; second turn kernel "
              f"{statistics.median(kern_2):.4f}, plain {statistics.median(plain_2):.4f}; {smi}")
        if c == CYCLES:
            # for scale, not a bound and not the kernel's function: what one
            # PyTorch reduction reaches reading the same planes once
            s_ms = statistics.median(time_ms(lambda xr, xi: (xr.sum(), xi.sum()), inputs))
            phase("time", f"C={c} f32, for scale: torch.sum over both planes {s_ms:.4f} ms "
                  f"({c * a * n * 8 / (s_ms * 1e-3) / 1e9:.0f} GB/s read); {smi}")
            # bf16 ingest: the same float32 passes on half the bytes
            half = [(xr.bfloat16(), xi.bfloat16()) for xr, xi in inputs]
            h_ms = statistics.median(time_ms(kern, half))
            b_ms, by = sense_bound(c, a, n, 2)
            gbs = c * a * n * 4 / (h_ms * 1e-3) / 1e9
            phase("time", f"C={c} bf16 input: kernel {h_ms:.4f} ms/dispatch ({msps / h_ms:.0f} "
                  f"MS/s, {gbs:.0f} GB/s read, {gbs / 3350:.1%} of 3.35 TB/s; bound {b_ms:.4f} ms "
                  f"by {by}, so {h_ms / b_ms:.2f}x its bound), median of 3; {smi}")

            # the classify form beside fused_sense_ct (CUDA events in turns, and
            # the profiler's durations over alternations), its plain version,
            # the trace kernel, and the wrappers' host time at C=1
            sk = {"kernels": {}}
            measure_kernels(sk, dev, params, torch.Generator(device=dev).manual_seed(5), smi)
            sk = sk["kernels"]
            tail.update(
                f32=statistics.median(sk["f32"]["events_ms"]["fused_sense_classify"]),
                bf16=statistics.median(sk["bf16"]["events_ms"]["fused_sense_classify"]),
                plain=sk["classify_plain_ms"], trace=sk["sense_trace"]["ms"],
                trace_plain=sk["sense_trace"]["plain_ms"],
                on_card={k: sk[k]["on_card_ms"] for k in ("f32", "bf16")},
                trace_on_card=sk["sense_trace"]["on_card_ms"])
            del half
        del inputs

    extract_entry = link_phases(dev, smi)
    new_entries = wideband_and_dense_phases(dev, smi, planar, trace, params)
    del planar
    resolve_entry, stream_extract, stream_viterbi = stream_phases(dev, smi)
    viterbi_entry = viterbi_phase(dev, smi, stream_viterbi)
    scn = scenario_phases(smi)
    dist = distributed_phases(smi, scn)
    train = training_phases(dev, smi)
    sharded = sharded_phases(smi)
    extract_entry.update(stream_extract)
    extract_entry["max_abs_err"] = max(
        extract_entry["max_abs_err"], stream_extract["stream_step_max_abs_err"])
    bound_ms, bound_by = sense_bound(CYCLES, a, n, 4)
    kernels = [{
        "name": "fused_sense_ct",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": times[CYCLES][0],
        "plain_ms": times[CYCLES][1],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # FFT + magnitude + mean + band sums: no single PyTorch call
        "tail_ms": tail["f32"],
        "tail_bf16_ms": tail["bf16"],
        "tail_plain_ms": tail["plain"],
        # the profiler's kernel durations, the two forms alternating
        "on_card_ms": {k: v["fused_sense_ct"] for k, v in tail["on_card"].items()},
        "tail_on_card_ms": {k: v["fused_sense_classify"] for k, v in tail["on_card"].items()},
        "tail_max_abs_err": tail_err,
        "path_calls": {k: {"device_ops": v["ops"], "ms": v["ms"], "busy_us": v["busy_us"]}
                       for k, v in scn["path_calls"].items()},
        "scenario_launches": {"predictive_model.cfg": scn["predictive"],
                              "predictive_model.cfg -d, SU node": dist["predictive"]},
        "training_launches": {"make_dataset": train["make_dataset"],
                              "evaluation": train["evaluation"]},
    }, {
        "name": "sense_trace",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": TRACE_REPLACES,
        "launches": trace_launches,
        "max_abs_err": 0.0,  # held torch.equal to its plain version (phases 2, 4)
        "ms": tail["trace"],
        "on_card_ms": tail["trace_on_card"],
        "plain_ms": tail["trace_plain"],
        # C int32 decisions read and C float32 frequencies written; no arithmetic to speak of
        "bound_ms": bound(CYCLES * 8, 0)[0],
        "bound_by": "bytes",
        "library_ms": None,  # a scan of "the last non-zero": no single PyTorch call
    }, extract_entry, *new_entries, resolve_entry, viterbi_entry]
    viterbi_entry["scenario_launches"] = {"predictive_model.cfg": scn["predictive_viterbi"]}
    new_entries[0]["training_launches"] = {"train_steps": train["train_steps"]}
    new_entries[0]["sharded_launches"] = sharded["wideband"]
    extract_entry["sharded_launches"] = sharded["extract"]
    extract_entry["scenario_launches"] = {
        "two_node_link": scn["link"], "eight_node.cfg": scn["eight_node"],
        "predictive_model.cfg": scn["predictive_extract"],
        "two_node_link -d, per node": dist["link"], "eight_node.cfg -d, per node": dist["eight_node"]}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
