"""CLI entry of the port (the ``crts_controller`` equivalent).

    python -m cognitive_radio_network_tpu_torch scenario scenarios/predictive_model.cfg
    python -m cognitive_radio_network_tpu_torch master scenarios/scenario_master_template.cfg
    python -m cognitive_radio_network_tpu_torch engines
    python -m cognitive_radio_network_tpu_torch sense capture.iq -o out.npz

``scenario`` and ``master`` run scenarios in-process against the simulated
medium and write structured logs (npz + Octave export) under ``--log-dir``;
``sense`` streams a recorded IQ capture through sense->classify in
dispatches of ``--cycles-per-dispatch`` cycles.  Each runs on ``--device``
(default ``cuda``; there is no fallback to the CPU when no card is found).
The reference's distributed runs (``scenario -d`` and ``node``), ``train``,
``spectrum``, ``export`` and ``radio-host`` are not ported yet.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _cmd_sense(args) -> int:
    """Stream a capture through sense->classify: the deployment hot path.

    Blocks of the Python reader are de-interleaved to planar on the host,
    batched into dispatches of cycles_per_dispatch sense cycles and copied
    to the device; decisions, features and the tx-retune trace accumulate
    on the host."""
    import dataclasses
    import time

    import numpy as np
    import torch

    from cognitive_radio_network_tpu_torch.io.iq import IQReader, StreamCursor
    from cognitive_radio_network_tpu_torch.models import SenseConfig, make_sense_fn
    from cognitive_radio_network_tpu_torch.signal.mlp import reference_weights

    device = torch.device(args.device)
    cfg = SenseConfig()
    if args.weights:
        from cognitive_radio_network_tpu_torch.io.checkpoint import load_mlp_with_meta

        params, meta = load_mlp_with_meta(args.weights, device=device)
        cfg = dataclasses.replace(cfg, feature_transform=meta["feature_transform"])
    else:
        params = reference_weights(device=device)
    fn = make_sense_fn(cfg, device=device)

    cursor = (
        StreamCursor.load(args.cursor)
        if args.cursor and Path(args.cursor).exists()
        else StreamCursor()
    )
    reader = IQReader(args.capture, cursor)
    block_samples = cfg.samples_per_cycle * args.cycles_per_dispatch
    rows = args.cycles_per_dispatch * cfg.averaging

    decisions, features, freqs = [], [], []
    tx_freq = 833e6
    ch1, ch2, _ = cfg.channels_hz
    retune = {1: ch2, 2: ch1, 3: ch2}  # next_tx_channel: 1->ch2, 2->ch1, 3->ch2, 0->keep
    n_samples = 0
    t0 = None  # started after the first dispatch (excludes the kernel build)
    timed_samples = 0
    for b in reader.blocks(block_samples):
        planar = tuple(
            torch.from_numpy(b[:, i].copy()).reshape(rows, cfg.fft_length).to(device)
            for i in (0, 1)
        )
        out = fn(planar, params)
        dec = out["decision"].cpu().numpy()
        decisions.append(dec)
        features.append(out["features"].cpu().numpy())
        for d in dec:
            tx_freq = retune.get(int(d), tx_freq)
            freqs.append(tx_freq)
        n_samples += block_samples
        if t0 is None:
            t0 = time.perf_counter()
        else:
            timed_samples += block_samples
    elapsed = (time.perf_counter() - t0) if t0 is not None else 0.0
    if args.cursor:
        reader.cursor.save(args.cursor)
    if not decisions:
        print("capture shorter than one dispatch; nothing sensed")
        return 1
    dec = np.concatenate(decisions)
    feats = np.concatenate(features)
    occ = np.bincount(dec, minlength=4)
    rate = timed_samples / elapsed / 1e6 if elapsed > 0 and timed_samples else 0.0
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(
        f"sensed {n_samples/1e6:.1f} MSamples on {where} "
        f"({rate:.0f} MS/s steady-state incl. host reads, excl. first dispatch) "
        f"-> {len(dec)} cycles; "
        f"decisions: all-busy={occ[0]} ch1={occ[1]} ch2={occ[2]} ch3={occ[3]}; "
        f"final tx {freqs[-1]/1e6:.0f} MHz"
    )
    if args.out:
        np.savez_compressed(
            args.out,
            decision=dec,
            features=feats,
            tx_freq=np.asarray(freqs, np.float64),
            sample_rate_hz=reader.sample_rate_hz,
            center_hz=reader.center_hz,
        )
        print(f"saved {args.out}")
    return 0


def _cmd_runtime(args) -> int:
    """``scenario``, ``master`` and ``engines``: the in-process runtime."""
    from cognitive_radio_network_tpu_torch.runtime import (
        MasterConfig,
        controller_names,
        engine_names,
        load_master,
        load_scenario,
        run_master,
    )

    if args.cmd == "engines":
        print("cognitive engines:", ", ".join(engine_names()))
        print("scenario controllers:", ", ".join(controller_names()))
        return 0
    if args.cmd == "scenario":

        def _load(name):
            c = load_scenario(args.path)
            if args.run_time is not None:
                c.run_time = args.run_time
            return c

        master = MasterConfig(
            scenarios=[(_load(None).name, args.reps)], octave_log_summary=True
        )
        runs = run_master(master, _load, args.log_dir, device=args.device)
    else:
        master = load_master(args.path)
        base = Path(args.path).parent
        runs = run_master(
            master,
            lambda name: load_scenario(base / f"{name}.cfg"),
            args.log_dir,
            device=args.device,
        )
    any_failed = False
    for s, failed in runs:
        print(
            f"{s.scenario} rep {s.rep}: bytes_sent={s.bytes_sent} "
            f"bytes_received={s.bytes_received} valid_frames={s.valid_frames}"
        )
        for idx, err in sorted(failed.items()):
            print(f"{s.scenario} rep {s.rep}: node {idx} failed: {err}", file=sys.stderr)
        any_failed = any_failed or bool(failed)
    return 1 if any_failed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cognitive_radio_network_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def device_arg(p):
        p.add_argument(
            "--device", default="cuda", help="torch device to run on (default: cuda)"
        )

    sp = sub.add_parser("scenario", help="run one scenario file")
    sp.add_argument("path")
    sp.add_argument("-r", "--reps", type=int, default=1)
    sp.add_argument("-l", "--log-dir", default="logs")
    sp.add_argument("-t", "--run-time", type=float, default=None)
    device_arg(sp)

    mp = sub.add_parser("master", help="run a master scenario list")
    mp.add_argument("path")
    mp.add_argument("-l", "--log-dir", default="logs")
    device_arg(mp)

    sub.add_parser("engines", help="list registered engines/controllers")

    sn = sub.add_parser(
        "sense",
        help="stream a recorded IQ capture through the fused sense->classify "
        "pipeline (planar ingest -> CUDA kernel)",
    )
    sn.add_argument("capture", help="raw interleaved f32 I/Q file (io.IQWriter)")
    sn.add_argument("-o", "--out", default=None, help="save results .npz")
    sn.add_argument("-c", "--cycles-per-dispatch", type=int, default=256)
    sn.add_argument("--cursor", default=None, help="resume cursor file")
    sn.add_argument(
        "-w", "--weights", default=None, help="trained MLP checkpoint (npz)"
    )
    device_arg(sn)
    args = ap.parse_args(argv)
    if args.cmd == "sense":
        return _cmd_sense(args)
    return _cmd_runtime(args)


if __name__ == "__main__":
    sys.exit(main())
