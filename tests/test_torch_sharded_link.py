"""Port parity: the time-sharded OFDM receivers (PyTorch, gloo ranks on the
CPU) vs the port's one-device receivers and the JAX package's sharded ones.

Mirrors tests/test_sharded_link.py::TestShardedLink: a frame placed across
every seam of an 8-shard stream, and the adaptive receiver fed blocks that
cut frames, must decode exactly the frames of the one-device receivers,
byte for byte (offsets, headers, payloads, CRC flags).  The device-resident
cases and the reference faults 3 and 4 are in
tests/test_torch_sharded_stream.py.  One fleet of 8 ranks runs every case's
port side once per module (the memory case on meshes over the first 2 and 4
ranks); the same numpy streams go to the JAX receivers on 8 virtual devices.
No JAX at module level: the ranks import this file.
"""

import numpy as np
import pytest

from cognitive_radio_network_tpu_torch.graft_entry import _frames as frames_of
from cognitive_radio_network_tpu_torch.parallel import MeshSpec, make_mesh
from cognitive_radio_network_tpu_torch.parallel.launch import run_ranks
from cognitive_radio_network_tpu_torch.parallel.phylink import (
    ShardedFrameReceiver,
    ShardedStreamReceiver,
)
from cognitive_radio_network_tpu_torch.phy import OFDMFrameConfig, OFDMFrameGen, OFDMFrameSync
from cognitive_radio_network_tpu_torch.phy.framegen import gen_for
from cognitive_radio_network_tpu_torch.phy.framesync import StreamReceiver, _bucket_len
from cognitive_radio_network_tpu_torch.phy.stream import _prefix_len

WORLD = 8
QAM16 = dict(mod_scheme="qam16", fec0="v27", fec1="none")


def straddling_stream(seed, payload_len, n_shards=8, shard_len=None):
    """tests/test_sharded_link.py::_straddling_stream: one frame straddling
    every shard seam plus one inside each shard."""
    rng = np.random.default_rng(seed)
    gen = OFDMFrameGen(OFDMFrameConfig(), payload_len)
    flen = gen.frame_len
    shard_len = shard_len or 4 * flen
    n = n_shards * shard_len
    b = 2 * n_shards - 1
    headers = rng.integers(0, 256, (b, 8)).astype(np.uint8)
    payloads = rng.integers(0, 256, (b, payload_len)).astype(np.uint8)
    iq = gen.assemble(headers, payloads, device="cpu").numpy()
    stream = 0.005 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    offs = sorted(
        [s * shard_len - flen // 2 for s in range(1, n_shards)]
        + [s * shard_len + shard_len // 4 for s in range(n_shards)]
    )
    for i, o in enumerate(offs):
        stream[o : o + flen] += iq[i]
    return stream, offs, headers[: len(offs)], payloads[: len(offs)]


def mixed_stream(seed):
    """tests/test_sharded_link.py:98-111: qam4/h128 40-byte and qam16/v27
    96-byte frames interleaved with 700-sample gaps; and its block size."""
    rng = np.random.default_rng(seed)
    gen_a = OFDMFrameGen(OFDMFrameConfig(), 40)
    gen_b = OFDMFrameGen(OFDMFrameConfig(**QAM16), 96)
    pay_a = rng.integers(0, 256, (3, 40)).astype(np.uint8)
    pay_b = rng.integers(0, 256, (3, 96)).astype(np.uint8)
    hdr = rng.integers(0, 256, (6, 8)).astype(np.uint8)
    iq_a = gen_a.assemble(hdr[:3], pay_a, device="cpu").numpy()
    iq_b = gen_b.assemble(hdr[3:], pay_b, device="cpu").numpy()
    gap = np.zeros(700, np.complex64)
    stream = np.concatenate(
        [gap, iq_a[0], gap, iq_b[0], gap, iq_a[1], gap, iq_b[1], gap, iq_a[2], gap, iq_b[2], gap, gap]
    )
    blk = max(gen_a.frame_len, gen_b.frame_len) - 97  # force straddlers
    return stream, blk, pay_a, pay_b


def partial_stream(seed):
    """tests/test_sharded_link.py:181-187: one 64-byte frame after 900
    zeros, and the cut in its middle."""
    rng = np.random.default_rng(seed)
    gen = OFDMFrameGen(OFDMFrameConfig(), 64)
    hdr = rng.integers(0, 256, (1, 8)).astype(np.uint8)
    pay = rng.integers(0, 256, (1, 64)).astype(np.uint8)
    iq = gen.assemble(hdr, pay, device="cpu").numpy()[0]
    stream = np.concatenate([np.zeros(900, np.complex64), iq, np.zeros(400, np.complex64)])
    return stream, 900 + gen.frame_len // 2, pay[0]


def seam_stream(seed):
    """tests/test_sharded_link.py:139-163: a frame across every seam of the
    shard length a fresh 8-rank receiver picks for the block."""
    cfg = OFDMFrameConfig()
    gen = OFDMFrameGen(cfg, 48)
    scan_halo = _prefix_len(gen_for(cfg, 1)) + 8 * cfg.num_subcarriers
    shard_len = 1 << int(np.ceil(np.log2(max(4 * gen.frame_len, scan_halo, 4 * cfg.num_subcarriers))))
    return straddling_stream(seed, 48, 8, shard_len)


def _inputs() -> dict:
    return {
        "straddle": straddling_stream(11, 48),
        "ownership": straddling_stream(12, 32),
        "mixed": mixed_stream(13),
        "seam": seam_stream(14),
        "partial": partial_stream(15),
        "memory": straddling_stream(16, 48),
    }


def _rank(inp: dict) -> dict:
    import cognitive_radio_network_tpu_torch.parallel.phylink as phylink

    cfg = OFDMFrameConfig()
    m8 = make_mesh(MeshSpec(time=8), device="cpu")
    sub = {d: make_mesh(MeshSpec(time=d), device="cpu") for d in (2, 4)}
    out = {}
    stream = inp["straddle"][0]
    out["straddle"] = frames_of(ShardedFrameReceiver(cfg, 48, m8, k_per_shard=8, device="cpu")
                                .receive(stream))
    out["ownership"] = frames_of(ShardedFrameReceiver(cfg, 32, m8, k_per_shard=8, device="cpu")
                                 .receive(inp["ownership"][0]))
    stream, blk, _, _ = inp["mixed"]
    rx = ShardedStreamReceiver(cfg, m8, k_per_shard=8, device="cpu")
    out["mixed"] = sum((frames_of(rx.receive(stream[s : s + blk]))
                        for s in range(0, len(stream), blk)), [])
    rx = ShardedStreamReceiver(cfg, m8, k_per_shard=8, device="cpu")
    out["seam"] = frames_of(rx.receive(inp["seam"][0]))
    stream, cut, _ = inp["partial"]
    rx = ShardedStreamReceiver(cfg, m8, k_per_shard=4, device="cpu")
    out["partial"] = (frames_of(rx.receive(stream[:cut])), frames_of(rx.receive(stream[cut:])))

    # what each rank holds and moves: the planes the scan and the decode's
    # gather see, and every host-to-device move, on meshes of 2 and 4
    seen = {"scan": [], "extract": [], "place": []}
    wrapped = phylink._scan_block_graph, phylink.extract_windows, phylink._place

    def scan(layout, rr, ri, n_valid, *, k):
        seen["scan"].append(rr.shape[0])
        return wrapped[0](layout, rr, ri, n_valid, k=k)

    def extract(rr, ri, offsets, wlen):
        seen["extract"].append((rr.shape[0], offsets.shape[0], wlen))
        return wrapped[1](rr, ri, offsets, wlen)

    def place(x, device):
        seen["place"].append(x.shape[0])
        return wrapped[2](x, device)

    out["memory"] = {}
    for d, mesh in sub.items():
        if mesh is None:
            continue
        for k in seen:
            seen[k] = []
        phylink._scan_block_graph, phylink.extract_windows, phylink._place = scan, extract, place
        try:
            rx = ShardedStreamReceiver(cfg, mesh, k_per_shard=16, device="cpu")
            frames = frames_of(rx.receive(inp["memory"][0]))
        finally:
            phylink._scan_block_graph, phylink.extract_windows, phylink._place = wrapped
        out["memory"][d] = (frames, rx.scan_halo, {k: list(v) for k, v in seen.items()})
    return out


@pytest.fixture(scope="module")
def fleet():
    inp = _inputs()
    results = run_ranks(_rank, WORLD, backend="gloo", device="cpu", args=(inp,), timeout_s=300)
    for key in ("straddle", "ownership", "mixed", "seam", "partial"):
        assert all(r[key] == results[0][key] for r in results), f"ranks disagree on {key}"
    return inp, results[0], results


def _one_device_stream(stream, blk):
    rx = StreamReceiver(OFDMFrameConfig(), device="cpu")
    return sum((frames_of(rx.process(stream[s : s + blk])) for s in range(0, len(stream), blk)), [])


def _jax_mesh(d=8):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:d]).reshape(d), ("time",))


class TestShardedLink:
    def test_boundary_straddlers_bitmatch_single_device_and_jax(self, fleet):
        from cognitive_radio_network_tpu.parallel.phylink import (
            ShardedFrameReceiver as JaxFrameReceiver,
        )
        from cognitive_radio_network_tpu.phy import OFDMFrameConfig as JaxConfig

        inp, got, _ = fleet
        stream, offs, headers, payloads = inp["straddle"]
        frames = got["straddle"]
        assert len(frames) == len(offs), ([f[0] for f in frames], offs)
        single = _one_device_stream(stream, len(stream) // 16)
        assert len(single) == len(offs)
        for f, fs, o, p in zip(frames, single, offs, payloads):
            assert abs(f[0] - o) <= 2
            assert f[:5] == fs[:5]
            assert f[2] == bytes(p)
            assert f[4]
        want = frames_of(JaxFrameReceiver(JaxConfig(), 48, _jax_mesh(), k_per_shard=8).receive(stream))
        assert [f[:5] for f in frames] == [f[:5] for f in want]

    def test_ownership_no_duplicates(self, fleet):
        inp, got, _ = fleet
        offs = [f[0] for f in got["ownership"]]
        assert len(offs) == len(set(offs)) == len(inp["ownership"][1])

    def test_sharded_stream_mixed_configs_bitmatch(self, fleet):
        inp, got, _ = fleet
        stream, blk, pay_a, pay_b = inp["mixed"]
        frames = got["mixed"]
        single = _one_device_stream(stream, blk)
        assert len(frames) == len(single) == 6
        assert {len(f[2]) for f in frames} == {40, 96}
        assert frames == single
        assert all(f[4] for f in frames)
        assert [f[2] for f in frames if len(f[2]) == 40] == [bytes(p) for p in pay_a]
        assert [f[2] for f in frames if len(f[2]) == 96] == [bytes(p) for p in pay_b]

    def test_sharded_stream_shard_seam_straddlers_bitmatch_jax(self, fleet):
        from cognitive_radio_network_tpu.parallel.phylink import (
            ShardedStreamReceiver as JaxStreamReceiver,
        )
        from cognitive_radio_network_tpu.phy import OFDMFrameConfig as JaxConfig

        inp, got, _ = fleet
        stream, offs, _, _ = inp["seam"]
        frames = got["seam"]
        assert len({f[0] for f in frames}) == len(frames) == len(offs)
        ref = frames_of(StreamReceiver(OFDMFrameConfig(), device="cpu").process(stream))
        assert len(ref) == len(offs)
        for f, r, o in zip(frames, ref, offs):
            assert abs(f[0] - o) <= 2
            assert f == r
        want = frames_of(JaxStreamReceiver(JaxConfig(), _jax_mesh(), k_per_shard=8).receive(stream))
        assert frames == want

    def test_sharded_stream_residual_carries_partial_frame(self, fleet):
        inp, got, _ = fleet
        _, _, pay = inp["partial"]
        first, second = got["partial"]
        assert first == []
        assert len(second) == 1
        assert abs(second[0][0] - 900) <= 2
        assert second[0][2] == bytes(pay)

    def test_matches_fused_single_device_receive_block(self, fleet):
        inp, got, _ = fleet
        stream = inp["straddle"][0]
        ref = frames_of(OFDMFrameSync(OFDMFrameConfig(), 48, device="cpu").receive_block(stream, k=32))
        assert len(got["straddle"]) == len(ref)
        assert got["straddle"] == ref

    def test_decode_stage_per_rank_memory_shrinks_with_mesh(self, fleet):
        """Each rank's scan sees its segment plus the header-prefix halo, its
        decode gathers from its segment padded by a frame on both sides, and
        it moves to its device only pieces of its own segment: all of it
        bucketed n/d, shrinking with the mesh.  The only whole-frame arrays
        are the (G, frame_len) windows."""
        inp, _, results = fleet
        stream, offs, _, _ = inp["memory"]
        n = len(stream)
        flen = OFDMFrameGen(OFDMFrameConfig(), 48).frame_len
        outs = {}
        for d in (2, 4):
            per_rank = [r["memory"][d] for r in results[:d]]
            assert all("memory" in r and d not in r["memory"] for r in results[d:])
            for frames, scan_halo, seen in per_rank:
                assert len(frames) == len(offs)
                (ext,) = set(seen["scan"])  # one scan, every rank the same length
                shard_len = ext - scan_halo
                assert shard_len == _bucket_len(shard_len)  # a bucket length
                assert shard_len < n, (d, shard_len, n)
                assert shard_len * d <= 1.25 * n + d  # the eighth-octave bucket bound
                decode = [e for e in seen["extract"] if e[2] == flen]
                assert decode and all(e[0] == shard_len + 2 * flen for e in decode), decode
                assert max(seen["place"]) <= shard_len, (max(seen["place"]), shard_len)
            outs[d] = per_rank[0][0]
            assert all(p[0] == outs[d] for p in per_rank)
        assert outs[2] == outs[4]
