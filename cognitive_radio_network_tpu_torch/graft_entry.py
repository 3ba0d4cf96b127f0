"""Entry points of the port: one-device forward step and a multi-rank dry run.

The port's counterpart of the repository's ``__graft_entry__.py``:

entry()              -> (fn, example_args): the sense->classify forward of the
                        flagship fused pipeline, and example planes on the
                        device.
dryrun_multichip(n)  -> n ranks (:func:`..parallel.launch.run_ranks`) on a mesh
                        spanning the framework's axes (data x time x
                        channel): one sharded wideband train step, the
                        sharded fixed-config receiver on frames straddling
                        the shard seams, and the sharded streaming receiver
                        fed a stream cut mid-frame, at tiny shapes; then the
                        wideband detector at ``WidebandConfig()`` (M=64, P=8,
                        the widths the fused kernel takes) over the mesh.

Unlike the reference, which checks that each stage runs, the dry run holds
each stage to its one-device counterpart: the sharded loss within rtol 1e-5
of the one-device step's from the same parameters, the frames equal byte
for byte (offsets, headers, payloads, CRC flags), and each rank's block of
the M=64 energy within rtol 1e-5 of one device's.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]

_LOSS_RTOL = 1e-5


def entry(device="cuda"):
    """(fn, (iq,)): ``fn`` maps (16, A, N, 2) float32 planes to the 16
    cycles' decisions; the planes, drawn from a seeded numpy generator, lie
    on ``device`` (the card unless the caller asks for the CPU)."""
    from cognitive_radio_network_tpu_torch.models import SenseConfig, sense_classify
    from cognitive_radio_network_tpu_torch.signal.mlp import reference_weights

    cfg = SenseConfig()
    params = reference_weights(device=device)

    def fn(iq_planes):
        return sense_classify(iq_planes, params, cfg)["decision"]

    rng = np.random.default_rng(0)
    iq = rng.standard_normal((16, cfg.averaging, cfg.fft_length, 2), dtype=np.float32)
    return fn, (torch.from_numpy(iq).to(device),)


def _mesh_spec(n: int):
    from cognitive_radio_network_tpu_torch.parallel import MeshSpec

    if n >= 8 and n % 8 == 0:
        return MeshSpec(time=2, channel=2, data=n // 4)
    if n == 4:
        return MeshSpec(time=2, channel=2)
    if n == 2:
        return MeshSpec(time=2)
    return MeshSpec(time=n)


def _frames(frames) -> list:
    """Frames as comparable tuples: offset, header, payload, CRC flags,
    modulation and outer FEC (what the receivers must give alike)."""
    return [
        (int(f["offset"]), bytes(np.asarray(f["header"])), bytes(np.asarray(f["payload"])),
         f["stats"].header_valid, f["stats"].payload_valid, f["stats"].mod_scheme,
         f["stats"].fec0)
        for f in frames
    ]


def _dryrun_rank(n_devices: int, device: str) -> dict:
    """One rank of :func:`dryrun_multichip`: the three stages, each held to
    its one-device counterpart on this rank."""
    import torch.distributed as dist

    from cognitive_radio_network_tpu_torch.models.distributed import make_sharded_train_step
    from cognitive_radio_network_tpu_torch.models.train import TrainConfig, TrainState, make_optimizer
    from cognitive_radio_network_tpu_torch.parallel import WidebandConfig, make_mesh, make_wideband_fn
    from cognitive_radio_network_tpu_torch.parallel.mesh import axis_size, block_range
    from cognitive_radio_network_tpu_torch.parallel.phylink import (
        ShardedFrameReceiver,
        ShardedStreamReceiver,
    )
    from cognitive_radio_network_tpu_torch.phy import OFDMFrameConfig, OFDMFrameGen, OFDMFrameSync
    from cognitive_radio_network_tpu_torch.phy.stream import StreamReceiver

    spec = _mesh_spec(n_devices)
    mesh = make_mesh(spec, device=device)
    dev = torch.device(device)

    cfg = WidebandConfig(num_channels=8, taps_per_channel=4, block_len=16)
    m = cfg.num_channels
    t_total = max(spec.time, 1) * 2 * cfg.block_len  # cycles per shard
    b = 2 * max(spec.data, 1)
    c = t_total // cfg.block_len
    rng = np.random.default_rng(0)
    planes = rng.standard_normal((b, t_total * m, 2), dtype=np.float32)
    labels = rng.integers(0, 2, (b, c, m)).astype(np.float32)

    init_fn, step_fn = make_sharded_train_step(cfg, mesh=mesh, device=dev)
    state = init_fn(torch.Generator(device=dev).manual_seed(dist.get_rank()))  # rank 0's wins
    one_params = copy.deepcopy(state.params)
    _, one_step = make_sharded_train_step(cfg, device=dev)
    one = TrainState(one_params, make_optimizer(TrainConfig(1e-3), one_params), 0)
    state, loss = step_fn(state, planes, labels)
    _, one_loss = one_step(one, planes, labels)
    loss_val, one_val = loss.item(), one_loss.item()
    if not np.isfinite(loss_val):
        raise AssertionError(f"non-finite loss: {loss_val}")
    if abs(loss_val - one_val) > _LOSS_RTOL * abs(one_val):
        raise AssertionError(f"sharded loss {loss_val} vs one-device {one_val}: beyond rtol 1e-5")

    # the PHY link stage: the time-sharded fixed-config receiver with the
    # frame-length halo (frames straddling shard seams must decode)
    ocfg = OFDMFrameConfig()
    ogen = OFDMFrameGen(ocfg, payload_len=16)
    d_time = axis_size(mesh, "time")
    shard_len = 2 * ogen.frame_len
    n = d_time * shard_len
    stream = 0.005 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    offs = [s * shard_len - ogen.frame_len // 2 for s in range(1, d_time)]
    offs += [shard_len // 4]
    hdrs = rng.integers(0, 256, (len(offs), 8)).astype(np.uint8)
    pays = rng.integers(0, 256, (len(offs), 16)).astype(np.uint8)
    iq = ogen.assemble(hdrs, pays, device=dev).cpu().numpy()
    for i, o in enumerate(sorted(offs)):
        stream[o : o + ogen.frame_len] += iq[i]
    rx = ShardedFrameReceiver(ocfg, 16, mesh, k_per_shard=4, device=dev)
    frames = _frames(rx.receive(stream))
    one_frames = _frames(OFDMFrameSync(ocfg, 16, device=dev).receive_block(stream, k=4 * d_time))
    if len(frames) != len(offs) or not all(f[4] for f in frames):
        raise AssertionError(f"fixed-config receiver: {len(frames)} of {len(offs)} frames")
    if frames != one_frames:
        raise AssertionError("the sharded fixed-config receiver's frames differ from one device's")

    # the adaptive stage: the streaming receiver on device-resident blocks,
    # the stream cut mid-frame
    srx = ShardedStreamReceiver(ocfg, mesh, k_per_shard=4, device=dev)
    one_rx = StreamReceiver(ocfg, device=dev)
    cut = sorted(offs)[0] + ogen.frame_len // 2
    sframes, one_sframes = [], []
    for seg in (stream[:cut], stream[cut:]):
        re = torch.from_numpy(seg.real.copy()).to(dev)
        im = torch.from_numpy(seg.imag.copy()).to(dev)
        sframes += _frames(srx.receive_device(re, im))
        one_sframes += _frames(one_rx.process(seg))
    if len(sframes) != len(offs) or not all(f[4] for f in sframes):
        raise AssertionError(f"streaming receiver: {len(sframes)} of {len(offs)} frames")
    if sframes != one_sframes:
        raise AssertionError("the sharded streaming receiver's frames differ from one device's")

    # the wideband detector at WidebandConfig() (M=64, P=8: the fused path),
    # two cycles per time shard, each rank's (time, channel) block held to
    # one device's
    wcfg = WidebandConfig()
    cycles = 2 * d_time
    wide = np.random.default_rng(1).standard_normal(
        (2, cycles * wcfg.block_len * wcfg.num_channels), dtype=np.float32)
    planes_w = tuple(torch.from_numpy(p).to(dev) for p in wide)
    got_e = make_wideband_fn(wcfg, mesh=mesh, device=dev)(planes_w)["energy"]
    whole_e = make_wideband_fn(wcfg, device=dev)(planes_w)["energy"]
    lo, hi = block_range(cycles, mesh, "time")
    c_lo, c_hi = block_range(wcfg.num_channels, mesh, "channel")
    torch.testing.assert_close(got_e, whole_e[lo:hi, c_lo:c_hi], rtol=1e-5, atol=1e-7)
    return {
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
        "loss": loss_val,
        "one_device_loss": one_val,
        "step": state.step,
        "phylink_frames": len(frames),
        "adaptive_frames": len(sframes),
        "placed": len(offs),
        "wideband_cycles": hi - lo,
    }


def dryrun_multichip(n_devices: int, *, backend: str | None = None, device="cuda") -> dict:
    """Run the dry run on ``n_devices`` ranks of one host (``backend`` as
    :func:`..parallel.multihost.initialize` takes it: ranks that share a card
    need ``"gloo"``).  Raises if a stage fails or parts from one device;
    prints one line and returns rank 0's summary."""
    from cognitive_radio_network_tpu_torch.parallel.launch import run_ranks

    results = run_ranks(
        _dryrun_rank, n_devices, backend=backend, device=device, args=(n_devices, str(device))
    )
    losses = {r["loss"] for r in results}
    if len(losses) != 1:
        raise AssertionError(f"the ranks' losses differ: {sorted(losses)}")
    out = results[0]
    print(
        f"dryrun_multichip ok: mesh={out['mesh']} loss={out['loss']:.6f} "
        f"(one device {out['one_device_loss']:.6f}) step={out['step']} "
        f"phylink_frames={out['phylink_frames']}/{out['placed']} "
        f"adaptive_frames={out['adaptive_frames']}/{out['placed']}",
        flush=True,
    )
    return out
