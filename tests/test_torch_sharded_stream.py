"""Port parity: the sharded streaming receiver's device-resident API, and the
reference's faults 3 and 4 as the port handles them (PyTorch, gloo ranks on
the CPU, vs the one-device ``StreamReceiver`` and the JAX package's
``ShardedStreamReceiver`` on 4 virtual devices).

Mirrors tests/test_sharded_link.py::TestDeviceResidentShardedStreaming.  The
two fault tests state the divergences from the reference (ROADMAP.md Queue
3): the reference's ``receive_device`` keeps a residual store of its own
beside the offset it shares with ``receive`` (parallel/phylink.py:522-549),
so switching API mid-frame loses the frame, and its ``_device_concat`` is
keyed on the exact block size (:478-499), one compiled program per size.  The
port keeps one residual store and sizes every call by bucket lengths.  One
fleet of 4 ranks runs the port's side once per module; frames are compared
byte for byte.  No JAX at module level: the ranks import this file.
"""

import numpy as np
import pytest
import torch

from cognitive_radio_network_tpu_torch.parallel import MeshSpec, make_mesh
from cognitive_radio_network_tpu_torch.parallel.launch import run_ranks
from cognitive_radio_network_tpu_torch.parallel.phylink import ShardedStreamReceiver
from cognitive_radio_network_tpu_torch.phy import OFDMFrameConfig
from cognitive_radio_network_tpu_torch.phy.framesync import StreamReceiver, _bucket_len
from test_torch_sharded_link import frames_of, mixed_stream, partial_stream

WORLD = 4
SIZES = (1100, 1300, 1700, 1900, 2300, 2900, 3100, 3700)  # block sizes of the fault-4 case


def _planes(seg):
    return torch.from_numpy(seg.real.copy()), torch.from_numpy(seg.imag.copy())


def _cut(stream, sizes):
    out, s, i = [], 0, 0
    while s < len(stream):
        out.append(stream[s : s + sizes[i % len(sizes)]])
        s += sizes[i % len(sizes)]
        i += 1
    return out


def _inputs() -> dict:
    mixed, blk, pay_a, pay_b = mixed_stream(21)
    return {
        "mixed": (mixed, blk),
        "partial": partial_stream(22),
        "sizes": _cut(mixed_stream(23)[0], SIZES),
    }


def _rank(inp: dict) -> dict:
    import cognitive_radio_network_tpu_torch.parallel.phylink as phylink

    cfg = OFDMFrameConfig()
    mesh = make_mesh(MeshSpec(time=WORLD), device="cpu")
    out = {}

    # receive_device vs receive on the same blocks; what receive_device moves
    stream, blk = inp["mixed"]
    host_rx = ShardedStreamReceiver(cfg, mesh, k_per_shard=8, device="cpu")
    dev_rx = ShardedStreamReceiver(cfg, mesh, k_per_shard=8, device="cpu")
    blocks = [stream[s : s + blk] for s in range(0, len(stream), blk)]
    staged = [_planes(seg) for seg in blocks]  # on the receiver's device before the calls
    moved = []
    place = phylink._place

    def spy(x, device):
        y = place(x, device)
        moved.append((x.shape[0], y is x))
        return y

    got_host, got_dev = [], []
    for seg, (br, bi) in zip(blocks, staged):
        got_host += frames_of(host_rx.receive(seg))
        phylink._place = spy
        try:
            got_dev += frames_of(dev_rx.receive_device(br, bi))
        finally:
            phylink._place = place
    out["device_vs_host"] = (got_dev, got_host, moved, blk)

    # a block ending mid-frame, on the device
    stream, cut, _ = inp["partial"]
    rx = ShardedStreamReceiver(cfg, mesh, k_per_shard=4, device="cpu")
    first = frames_of(rx.receive_device(*_planes(stream[:cut])))
    pending = rx.pending_frame
    out["partial_device"] = (first, pending, frames_of(rx.receive_device(*_planes(stream[cut:]))))

    # fault 3: the two APIs interleaved across the frame that straddles the cut
    out["interleaved"] = {}
    for order in ("host_then_device", "device_then_host"):
        rx = ShardedStreamReceiver(cfg, mesh, k_per_shard=4, device="cpu")
        frames = []
        for i, seg in enumerate((stream[:cut], stream[cut:])):
            on_device = (i == 0) == (order == "device_then_host")
            frames += frames_of(rx.receive_device(*_planes(seg)) if on_device else rx.receive(seg))
        out["interleaved"][order] = frames

    # fault 4: many block sizes, every per-call length a bucket length
    lens = []
    scan = phylink._scan_block_graph

    def spy_scan(layout, rr, ri, n_valid, *, k):
        lens.append(rr.shape[0])
        return scan(layout, rr, ri, n_valid, k=k)

    rx = ShardedStreamReceiver(cfg, mesh, k_per_shard=8, device="cpu")
    frames = []
    phylink._scan_block_graph = spy_scan
    try:
        for seg in inp["sizes"]:
            frames += frames_of(rx.receive_device(*_planes(seg)))
    finally:
        phylink._scan_block_graph = scan
    out["sizes"] = (frames, [n - rx.scan_halo for n in lens])
    return out


@pytest.fixture(scope="module")
def fleet():
    inp = _inputs()
    results = run_ranks(_rank, WORLD, backend="gloo", device="cpu", args=(inp,), timeout_s=300)
    for key in ("partial_device", "interleaved"):
        assert all(r[key] == results[0][key] for r in results), f"ranks disagree on {key}"
    return inp, results[0], results


def _jax_rx():
    import jax
    from jax.sharding import Mesh

    from cognitive_radio_network_tpu.parallel.phylink import ShardedStreamReceiver as JaxRx
    from cognitive_radio_network_tpu.phy import OFDMFrameConfig as JaxConfig

    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(WORLD), ("time",))
    return JaxRx(JaxConfig(), mesh, k_per_shard=8)


def _one_device(blocks):
    rx = StreamReceiver(OFDMFrameConfig(), device="cpu")
    return sum((frames_of(rx.process(seg)) for seg in blocks), [])


class TestDeviceResidentShardedStreaming:
    def test_bitmatch_and_no_block_copy(self, fleet):
        import jax.numpy as jnp

        inp, got, results = fleet
        stream, blk = inp["mixed"]
        for res in results:
            got_dev, got_host, moved, _ = res["device_vs_host"]
            assert len(got_dev) == len(got_host) == 6
            assert got_dev == got_host
            assert all(f[4] for f in got_dev)
            # the block's planes lay on the receiver's device: every piece of
            # them a rank took was used where it lay, never copied
            assert moved and all(same for _, same in moved), moved
        blocks = [stream[s : s + blk] for s in range(0, len(stream), blk)]
        assert got["device_vs_host"][0] == _one_device(blocks)
        jrx = _jax_rx()
        want = []
        for seg in blocks:
            want += frames_of(
                jrx.receive_device(jnp.asarray(seg.real.copy()), jnp.asarray(seg.imag.copy()))
            )
        assert got["device_vs_host"][0] == want

    def test_partial_frame_carry_on_device(self, fleet):
        inp, got, _ = fleet
        _, _, pay = inp["partial"]
        first, pending, second = got["partial_device"]
        assert first == []
        assert pending
        assert len(second) == 1
        assert abs(second[0][0] - 900) <= 2
        assert second[0][2] == bytes(pay)


class TestReferenceFaults:
    @pytest.mark.parametrize("order", ["host_then_device", "device_then_host"])
    def test_interleaved_apis_decode_the_straddling_frame_once(self, fleet, order):
        """Fault 3: one residual store for both APIs, so a frame cut by the
        switch decodes once, at its offset, as the one-device receiver gives
        it.  The reference, switching from ``receive`` to ``receive_device``,
        loses it (its device store is empty when the frame's tail comes)."""
        import jax.numpy as jnp

        inp, got, _ = fleet
        stream, cut, pay = inp["partial"]
        frames = got["interleaved"][order]
        want = _one_device([stream[:cut], stream[cut:]])
        assert len(want) == 1 and abs(want[0][0] - 900) <= 2 and want[0][2] == bytes(pay)
        assert frames == want
        if order == "host_then_device":
            jrx = _jax_rx()
            lost = frames_of(jrx.receive(stream[:cut]))
            tail = stream[cut:]
            lost += frames_of(
                jrx.receive_device(jnp.asarray(tail.real.copy()), jnp.asarray(tail.imag.copy()))
            )
            assert lost == [], lost  # the divergence: the reference drops the frame

    def test_many_block_sizes_keep_bucketed_lengths(self, fleet):
        """Fault 4: every per-call shard length is a ``_bucket_len`` length,
        so a run over many block sizes sees few; the frames are the
        one-device receiver's.  The reference compiles one concatenation
        per exact block size."""
        import jax.numpy as jnp

        inp, got, results = fleet
        frames, shard_lens = got["sizes"]
        assert frames == _one_device(inp["sizes"])
        assert len(frames) == 6
        assert all(s == _bucket_len(s) for s in shard_lens), shard_lens
        assert len(set(shard_lens)) < len(SIZES), sorted(set(shard_lens))
        for res in results[1:]:
            assert res["sizes"] == got["sizes"]
        jrx = _jax_rx()
        for seg in inp["sizes"][: len(SIZES)]:
            noise = np.zeros_like(seg)  # keys only: nothing to decode
            jrx.receive_device(jnp.asarray(noise.real.copy()), jnp.asarray(noise.imag.copy()))
        assert len(jrx._concat_cache) == len(SIZES)
