"""CLI entry of the port (the ``crts_controller`` equivalent).

    python -m cognitive_radio_network_tpu_torch scenario scenarios/predictive_model.cfg
    python -m cognitive_radio_network_tpu_torch master scenarios/scenario_master_template.cfg
    python -m cognitive_radio_network_tpu_torch engines
    python -m cognitive_radio_network_tpu_torch sense capture.iq -o out.npz
    python -m cognitive_radio_network_tpu_torch scenario -d scenarios/eight_node.cfg
    python -m cognitive_radio_network_tpu_torch export logs/bin -o run.m
    python -m cognitive_radio_network_tpu_torch train -n 400 -s 2000 -o ckpt.npz
    python -m cognitive_radio_network_tpu_torch spectrum demo

``scenario`` and ``master`` run scenarios in-process against the simulated
medium and write structured logs (npz + Octave export) under ``--log-dir``;
``scenario -d`` runs one as a TCP controller with one ``node`` process per
node (the ``crts_controller`` star topology); ``radio-host`` is the child
process of a ``python-process`` radio; ``sense`` streams a recorded IQ
capture through sense->classify in dispatches of ``--cycles-per-dispatch``
cycles; ``export`` converts saved logs to Octave; ``train`` fits the
occupancy classifier on synthetic scenes and writes a checkpoint that
``CE_Predictive_Node -w`` loads; ``spectrum`` is the headless spectrum
analyzer (:mod:`.tools.spectrum_analyzer`, its own flags).  Each that
computes runs on ``--device`` (default ``cuda``; there is no fallback to the
CPU when no card is found), and a distributed run hands its device to every
node.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _cmd_sense(args) -> int:
    """Stream a capture through sense->classify: the deployment hot path.

    The native prefetch thread de-interleaves the capture to planar off the
    hot path (native/src/iq_stream.cpp) in blocks of cycles_per_dispatch
    sense cycles; each plane goes to the device in one copy.  Decisions,
    features and the tx-retune trace accumulate on the host.  Without the
    native library the Python reader's blocks are de-interleaved here."""
    import dataclasses
    import time

    import numpy as np
    import torch

    from cognitive_radio_network_tpu_torch import native
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
    if native.available():
        stream = native.NativeIQStream(
            args.capture, block_samples, start_sample=cursor.sample_index
        )
        blocks, ingest = stream.planar_blocks(), "native prefetcher"
    else:
        stream = None
        blocks = ((b[:, 0].copy(), b[:, 1].copy()) for b in reader.blocks(block_samples))
        ingest = "Python reader"
    for xr, xi in blocks:
        planar = tuple(
            torch.from_numpy(x).reshape(rows, cfg.fft_length).to(device) for x in (xr, xi)
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
        if stream is not None:
            reader.cursor.sample_index = stream.cursor
    elapsed = (time.perf_counter() - t0) if t0 is not None else 0.0
    if stream is not None:
        stream.close()
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
        f"sensed {n_samples/1e6:.1f} MSamples on {where} through the {ingest} "
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

        if args.distributed:
            return _cmd_distributed(args, _load)
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
        _print_summary(s)
        for idx, err in sorted(failed.items()):
            print(f"{s.scenario} rep {s.rep}: node {idx} failed: {err}", file=sys.stderr)
        any_failed = any_failed or bool(failed)
    return 1 if any_failed else 0


def _print_summary(s) -> None:
    print(
        f"{s.scenario} rep {s.rep}: bytes_sent={s.bytes_sent} "
        f"bytes_received={s.bytes_received} valid_frames={s.valid_frames}"
    )


def _cmd_distributed(args, load) -> int:
    """``scenario -d``: each rep as a TCP controller with one node process
    per node.  Exits 1, naming each node on stderr, when a node sent no
    summary; a node that dies or stalls mid-run raises with its stderr."""
    from cognitive_radio_network_tpu_torch.runtime.netctl import NetController

    any_failed = False
    for rep in range(1, args.reps + 1):
        ctl = NetController(
            load(None),
            port=args.port,
            transport=args.transport,
            launch=args.launch or ("manual" if args.manual else "local"),
            controller_addr=args.addr,
            device=args.device,
        )
        s = ctl.run(rep)
        _print_summary(s)
        for i in range(len(ctl.cfg.nodes)):
            if i not in ctl.summaries:
                print(f"{s.scenario} rep {rep}: node {i} sent no summary", file=sys.stderr)
                any_failed = True
    return 1 if any_failed else 0


def _cmd_export(args) -> int:
    """Saved run logs (.npz, or a .crnl binary log or a directory of them)
    to Octave .m (the convert_logs_bin_to_octave equivalent)."""
    import numpy as np

    src = Path(args.path)
    columns: dict[str, np.ndarray] = {}
    if src.is_dir() or src.suffix == ".crnl":
        from cognitive_radio_network_tpu_torch.runtime.logging import (
            read_binlog,
            read_binlog_dir,
        )

        streams = read_binlog_dir(src) if src.is_dir() else dict([read_binlog(src)])
        for stream, recs in streams.items():
            if not recs:
                continue
            for k in recs[0]:
                columns[f"{stream}_{k}"] = np.array([r[k] for r in recs])
    else:
        with np.load(src, allow_pickle=True) as data:
            for key in data.files:
                columns[key.replace(".", "_")] = data[key]
    lines = []
    for var, v in columns.items():
        if v.dtype.kind in "OU":
            lines.append(f"{var} = {{{', '.join(repr(str(x)) for x in v)}}};")
        else:
            vals = ", ".join(str(x) for x in np.asarray(v, float))
            lines.append(f"{var} = [{vals}];")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("\n".join(lines) + "\n")
    print(f"wrote {len(lines)} variables to {args.out}")
    return 0


def _cmd_train(args) -> int:
    """Fit the occupancy classifier on a synthetic dataset and save it with
    its feature transform, so ``CE_Predictive_Node -w`` applies the same."""
    import torch

    from cognitive_radio_network_tpu_torch.io.checkpoint import save_mlp
    from cognitive_radio_network_tpu_torch.models.train import TrainConfig, fit, make_dataset
    from cognitive_radio_network_tpu_torch.utils.device import require_device

    device = require_device(args.device)
    feats, labels = make_dataset(
        torch.Generator(device=device).manual_seed(args.seed), args.num_examples, device=device
    )
    tcfg = TrainConfig(learning_rate=args.lr, num_steps=args.steps)
    params, losses = fit(
        torch.Generator(device=device).manual_seed(args.seed + 1), feats, labels, tcfg,
        device=device,
    )
    with torch.no_grad():
        preds = params(torch.log1p(feats)) > 0.5
    acc = float((preds == (labels > 0.5)).float().mean())
    save_mlp(args.out, params, feature_transform="log1p" if tcfg.log_features else "none")
    print(
        f"trained {args.num_examples} examples, {args.steps} steps: "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, accuracy {acc:.3f}; "
        f"saved {args.out}"
    )
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cognitive_radio_network_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def device_arg(p):
        p.add_argument(
            "--device", default="cuda", help="torch device to run on (default: cuda)"
        )

    def transport_arg(p):
        p.add_argument("--transport", choices=("auto", "native", "python"), default="auto")

    sp = sub.add_parser("scenario", help="run one scenario file")
    sp.add_argument("path")
    sp.add_argument("-r", "--reps", type=int, default=1)
    sp.add_argument("-l", "--log-dir", default="logs")
    sp.add_argument("-t", "--run-time", type=float, default=None)
    sp.add_argument(
        "-d",
        "--distributed",
        action="store_true",
        help="run as a TCP controller with one OS process per node "
        "(the crts_controller star topology)",
    )
    sp.add_argument("-p", "--port", type=int, default=4444)
    sp.add_argument(
        "-m",
        "--manual",
        action="store_true",
        help="with -d: don't launch local node processes; wait for "
        "operators to start them (crts_controller -m)",
    )
    transport_arg(sp)
    sp.add_argument(
        "--launch",
        choices=("local", "manual", "ssh"),
        default=None,
        help="with -d: node launch mode — 'ssh' starts each node on its "
        "configured server_ip over ssh with sysout capture and exact-PID "
        "remote kill (crts_controller.cpp:404-421)",
    )
    sp.add_argument(
        "-a",
        "--addr",
        default="127.0.0.1",
        help="with --launch ssh: the controller address remote nodes dial",
    )
    device_arg(sp)

    np_ = sub.add_parser(
        "node",
        help="node client process (the crts_cognitive_radio / crts_interferer "
        "equivalent): connects to a controller and runs the node pushed to it",
    )
    np_.add_argument("-a", "--controller", required=True, help="controller host")
    np_.add_argument("-p", "--port", type=int, default=4444)
    transport_arg(np_)
    device_arg(np_)

    rh = sub.add_parser(
        "radio-host",
        help="third-party radio child process (the reference's "
        "execvp'd python radio, src/crts_cognitive_radio.cpp:660-720): "
        "loads a user radio file and serves the stdin/stdout step "
        "protocol for a parent node (runtime/procradio.py)",
    )
    rh.add_argument("python_file")
    rh.add_argument("--node-id", type=int, required=True)
    rh.add_argument("--medium-rate", type=float, required=True)
    rh.add_argument("--medium-center", type=float, required=True)
    rh.add_argument("--config-json", required=True)
    device_arg(rh)

    mp = sub.add_parser("master", help="run a master scenario list")
    mp.add_argument("path")
    mp.add_argument("-l", "--log-dir", default="logs")
    device_arg(mp)

    sub.add_parser("engines", help="list registered engines/controllers")

    sn = sub.add_parser(
        "sense",
        help="stream a recorded IQ capture through the fused sense->classify "
        "pipeline (native prefetcher -> planar ingest -> CUDA kernel)",
    )
    sn.add_argument("capture", help="raw interleaved f32 I/Q file (io.IQWriter)")
    sn.add_argument("-o", "--out", default=None, help="save results .npz")
    sn.add_argument("-c", "--cycles-per-dispatch", type=int, default=256)
    sn.add_argument("--cursor", default=None, help="resume cursor file")
    sn.add_argument(
        "-w", "--weights", default=None, help="trained MLP checkpoint (npz)"
    )
    device_arg(sn)

    tp = sub.add_parser("train", help="train the occupancy classifier on synthetic scenes")
    tp.add_argument("-n", "--num-examples", type=int, default=400)
    tp.add_argument("-s", "--steps", type=int, default=2000)
    tp.add_argument("--lr", type=float, default=3e-3)
    tp.add_argument("-o", "--out", default="checkpoints/occupancy_mlp.npz")
    tp.add_argument("--seed", type=int, default=0)
    device_arg(tp)

    wp = sub.add_parser("spectrum", help="headless spectrum analyzer (its own --device)")
    wp.add_argument("spectrum_args", nargs=argparse.REMAINDER)

    xp = sub.add_parser(
        "export",
        help="convert saved run logs (.npz, or a .crnl binary log / directory "
        "of them) to Octave .m (the convert_logs_bin_to_octave equivalent)",
    )
    xp.add_argument("path")
    xp.add_argument("-o", "--out", required=True)

    args = ap.parse_args(argv)
    if args.cmd == "sense":
        return _cmd_sense(args)
    if args.cmd == "export":
        return _cmd_export(args)
    if args.cmd == "train":
        return _cmd_train(args)
    if args.cmd == "spectrum":
        from cognitive_radio_network_tpu_torch.tools.spectrum_analyzer import main as smain

        return smain(args.spectrum_args)
    if args.cmd == "node":
        from cognitive_radio_network_tpu_torch.runtime.netctl import run_node_client

        return run_node_client(args.controller, args.port, args.transport, args.device)
    if args.cmd == "radio-host":
        from cognitive_radio_network_tpu_torch.runtime.procradio import run_radio_host

        return run_radio_host(
            args.python_file,
            args.node_id,
            args.medium_rate,
            args.medium_center,
            args.config_json,
            args.device,
        )
    return _cmd_runtime(args)


if __name__ == "__main__":
    sys.exit(main())
