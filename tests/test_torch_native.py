"""The port's native runtime library (cognitive_radio_network_tpu_torch.native)
against tests/test_native.py's checks, and against the JAX package.

The port compiles the repo's native/src/*.cpp with g++ into build/native/
(never into the JAX package's directory).  Each subsystem is held to its
pure-Python counterpart: IQ prefetch stream vs io.iq.IQReader, binlog framing
and CRC integrity, framed TCP transport round trips, and the packet engine vs
signal.msequence / runtime.traffic (bit-identical).  Cross-package cases: the
.crnl spill of the two-node link scenario, export, prefetch_blocks and the
sense CLI's native ingest.  TCP ports 47700-47709 are this file's.
"""

import struct
import subprocess
import sys
import threading
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from cognitive_radio_network_tpu import native as jnative
from cognitive_radio_network_tpu import runtime as jrt
from cognitive_radio_network_tpu.__main__ import main as jax_cli
from cognitive_radio_network_tpu.io import iq as jiq
from cognitive_radio_network_tpu.runtime import logging as jlog
from cognitive_radio_network_tpu_torch import native
from cognitive_radio_network_tpu_torch import runtime as trt
from cognitive_radio_network_tpu_torch.__main__ import main as port_cli
from cognitive_radio_network_tpu_torch.env import scene as tscene
from cognitive_radio_network_tpu_torch.io import iq as tiq
from cognitive_radio_network_tpu_torch.runtime import logging as tlog

ROOT = Path(__file__).resolve().parents[1]


def _write_capture(tmp_path, n, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, 2)).astype(np.float32)
    path = tmp_path / "cap.iq"
    with tiq.IQWriter(path, 13e6, 833e6) as w:
        w.write(data)
    return path, data


# ---------------- build ----------------


def test_library_builds_into_the_ports_build_dir():
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent == ROOT / "build" / "native"
    assert native.load()._name == str(path)
    assert native.library_path() == path  # a hash of the same sources and flags


_BUILD_RACE = """
import sys, time
from pathlib import Path
sys.path.insert(0, {root!r})
out, counter, which = Path(sys.argv[1]), Path(sys.argv[2]), sys.argv[3]

def fake_compile(tmp, *extra):
    with open(counter, "a") as f:
        f.write("build\\n")
    time.sleep(0.5)  # a long build: the other processes arrive meanwhile
    tmp.write_bytes(b"library")

if which == "kernels":
    from cognitive_radio_network_tpu_torch.ops import _build as mod
    mod._compile = fake_compile
    mod.build(out)
else:
    from cognitive_radio_network_tpu_torch import native as mod
    mod._compile = fake_compile
    mod.library_path = lambda: out
    assert mod.load() is None  # the stand-in is no library: load reports it unavailable
assert out.read_bytes() == b"library"
"""


@pytest.mark.parametrize("which", ["kernels", "native"])
def test_concurrent_processes_build_once(tmp_path, which):
    """N processes on a fresh checkout: one build under the lock, the others
    find the finished file (never a partial one)."""
    out, counter = tmp_path / "lib" / "libx.so", tmp_path / "builds.txt"
    code = _BUILD_RACE.format(root=str(ROOT))
    procs = [
        subprocess.Popen([sys.executable, "-c", code, str(out), str(counter), which],
                         stderr=subprocess.PIPE, text=True)
        for _ in range(4)
    ]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    assert counter.read_text().splitlines() == ["build"]
    assert sorted(f.name for f in out.parent.iterdir()) == ["build.lock", "libx.so"]


# ---------------- IQ stream ----------------


class TestNativeIQStream:
    def test_blocks_match_file(self, tmp_path):
        path, data = _write_capture(tmp_path, 4096)
        with native.NativeIQStream(path, 512, depth=4) as s:
            assert s.num_samples == 4096
            blocks = list(s.blocks())
        assert len(blocks) == 8
        np.testing.assert_array_equal(np.concatenate(blocks), data)

    def test_partial_tail_dropped(self, tmp_path):
        path, _ = _write_capture(tmp_path, 1000)
        with native.NativeIQStream(path, 512) as s:
            assert len(list(s.blocks())) == 1  # 1000 // 512

    def test_resumable_cursor(self, tmp_path):
        path, data = _write_capture(tmp_path, 2048)
        with native.NativeIQStream(path, 256) as s:
            s.next_block()
            s.next_block()
            cur = s.cursor
        assert cur == 512
        with native.NativeIQStream(path, 256, start_sample=cur) as s2:
            np.testing.assert_array_equal(s2.next_block(), data[512:768])

    def test_loop_mode(self, tmp_path):
        path, data = _write_capture(tmp_path, 512)
        with native.NativeIQStream(path, 256, loop=True) as s:
            blocks = [s.next_block() for _ in range(6)]
        for i, b in enumerate(blocks):
            np.testing.assert_array_equal(b, data[(i % 2) * 256 : (i % 2) * 256 + 256])

    def test_planar_blocks(self, tmp_path):
        path, data = _write_capture(tmp_path, 2048, seed=21)
        with native.NativeIQStream(path, 512) as s:
            planar = list(s.planar_blocks())
        assert len(planar) == 4
        np.testing.assert_array_equal(np.concatenate([i for i, _ in planar]), data[:, 0])
        np.testing.assert_array_equal(np.concatenate([q for _, q in planar]), data[:, 1])

    def test_missing_capture_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            native.NativeIQStream(tmp_path / "none.iq", 512)

    def test_spsc_ring_under_pressure(self, tmp_path):
        """Small ring + bursty consumer: every block exactly once, in order."""
        import time

        n_blocks, block = 200, 256
        path, data = _write_capture(tmp_path, n_blocks * block, seed=3)
        with native.NativeIQStream(path, block, depth=2) as s:
            for i in range(n_blocks):
                if i % 17 == 0:
                    time.sleep(0.002)  # let the producer fill and stall
                np.testing.assert_array_equal(s.next_block(), data[i * block : (i + 1) * block])
            assert s.next_block() is None


class TestPrefetchBlocks:
    def test_matches_python_and_jax_readers(self, tmp_path):
        path, _ = _write_capture(tmp_path, 4096, seed=7)
        py = list(tiq.IQReader(path).blocks(512))
        pre = list(tiq.IQReader(path).prefetch_blocks(512))
        jax_pre = list(jiq.IQReader(path).prefetch_blocks(512))
        assert len(pre) == len(py) == len(jax_pre) == 8
        for a, b, c in zip(pre, py, jax_pre):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)

    def test_resumable_cursor_equals_jax(self, tmp_path):
        path, data = _write_capture(tmp_path, 4096, seed=11)
        readers = {"port": tiq.IQReader(path), "jax": jiq.IQReader(path)}
        for r in readers.values():
            it = r.prefetch_blocks(512)
            first = [next(it), next(it)]
            it.close()
            np.testing.assert_array_equal(np.concatenate(first), data[:1024])
        assert readers["port"].cursor.sample_index == readers["jax"].cursor.sample_index == 1024
        rest = list(tiq.IQReader(path, readers["port"].cursor).prefetch_blocks(512))
        assert len(rest) == 6
        np.testing.assert_array_equal(np.concatenate(rest), data[1024:])

    def test_loop(self, tmp_path):
        path, data = _write_capture(tmp_path, 1024, seed=5)
        it = tiq.IQReader(path).prefetch_blocks(512, loop=True)
        blocks = [next(it) for _ in range(5)]
        it.close()
        for i, b in enumerate(blocks):
            np.testing.assert_array_equal(b, data[(i % 2) * 512 : (i % 2 + 1) * 512])


# ---------------- binlog ----------------


class TestBinLog:
    def test_roundtrip_and_cross_read(self, tmp_path):
        p = tmp_path / "phy_rx.crnl"
        recs = [struct.pack("<ifd", i, 1.5 * i, 0.25 * i) for i in range(100)]
        with native.BinLogWriter(p, "phy_rx:<ifd") as w:
            for r in recs:
                w.append(r)
        for lib in (native, jnative):  # the same engine, the same file format
            with lib.BinLogReader(p) as rd:
                assert rd.stream_name == "phy_rx:<ifd"
                assert len(rd) == 100
                assert list(rd) == recs

    def test_variable_length_records(self, tmp_path):
        p = tmp_path / "v.crnl"
        recs = [bytes(range(i % 251)) for i in range(50)]
        with native.BinLogWriter(p, "var") as w:
            for r in recs:
                w.append(r)
        with native.BinLogReader(p) as rd:
            assert list(rd) == recs

    def test_truncated_tail_dropped(self, tmp_path):
        p = tmp_path / "t.crnl"
        with native.BinLogWriter(p, "s") as w:
            w.append(b"A" * 64)
            w.append(b"B" * 64)
        p.write_bytes(p.read_bytes()[:-10])  # a crash mid-record
        with native.BinLogReader(p) as rd:
            assert len(rd) == 1
            assert rd.record(0) == b"A" * 64

    def test_corruption_detected(self, tmp_path):
        p = tmp_path / "c.crnl"
        with native.BinLogWriter(p, "s") as w:
            w.append(b"hello world")
        raw = bytearray(p.read_bytes())
        raw[-3] ^= 0xFF  # flip a payload byte
        p.write_bytes(bytes(raw))
        with native.BinLogReader(p) as rd:
            with pytest.raises(OSError, match="CRC"):
                rd.record(0)

    def test_crc32_matches_zlib(self):
        for data in (b"", b"a", b"123456789", bytes(range(256))):
            assert native.crc32(data) == zlib.crc32(data)


# ---------------- transport ----------------


def _serve(body):
    t = threading.Thread(target=body)
    t.start()
    return t


class TestTransport:
    def test_roundtrip_and_timeout(self):
        srv = native.MsgTransport.listen(47700)
        got = {}

        def server():
            conn = native.MsgTransport.accept(srv, 5000)
            got["first"] = conn.recv(5000)
            conn.send(7, b"reply-payload")
            got["timeout"] = conn.recv(100)  # nothing more -> None
            conn.close()

        t = _serve(server)
        cli = native.MsgTransport.connect("127.0.0.1", 47700, 5000)
        cli.send(3, b"hello control plane")
        typ, payload = cli.recv(5000)
        t.join(10)
        assert not t.is_alive()
        assert got["first"] == (3, b"hello control plane")
        assert got["timeout"] is None
        assert (typ, payload) == (7, b"reply-payload")
        cli.close()
        native.MsgTransport.close_server(srv)

    def test_empty_and_large_payloads(self):
        srv = native.MsgTransport.listen(47701)
        out = {}

        def server():
            conn = native.MsgTransport.accept(srv, 5000)
            out["a"] = conn.recv(5000)
            out["b"] = conn.recv(5000)
            conn.close()

        t = _serve(server)
        cli = native.MsgTransport.connect("127.0.0.1", 47701, 5000)
        big = bytes(np.random.default_rng(0).integers(0, 256, 1 << 20, dtype=np.uint8))
        cli.send(1)
        cli.send(2, big)
        t.join(10)
        assert not t.is_alive()
        assert out["a"] == (1, b"") and out["b"] == (2, big)
        cli.close()
        native.MsgTransport.close_server(srv)

    def test_oversized_payload_keeps_stream_framed(self):
        srv = native.MsgTransport.listen(47702)
        out = {}

        def server():
            conn = native.MsgTransport.accept(srv, 5000)
            conn._cap = 64  # shrink the cap to force the -4 path
            conn._buf = None
            try:
                conn.recv(5000)
            except ValueError as e:
                out["err"] = str(e)
            out["next"] = conn.recv(5000)
            conn.close()

        t = _serve(server)
        cli = native.MsgTransport.connect("127.0.0.1", 47702, 5000)
        cli.send(2, bytes(range(200)))  # 200 > 64 cap
        cli.send(3, b"still-framed")
        t.join(10)
        assert not t.is_alive()
        assert "recv cap" in out["err"]
        assert out["next"] == (3, b"still-framed")
        cli.close()
        native.MsgTransport.close_server(srv)

    def test_peer_close_raises(self):
        srv = native.MsgTransport.listen(47703)

        def server():
            native.MsgTransport.accept(srv, 5000).close()

        t = _serve(server)
        cli = native.MsgTransport.connect("127.0.0.1", 47703, 5000)
        t.join(10)
        with pytest.raises(ConnectionResetError):
            cli.recv(5000)
        cli.close()
        native.MsgTransport.close_server(srv)


# ---------------- packet engine ----------------


class TestPacketEngine:
    def test_msequence_bitmatch_python(self):
        from cognitive_radio_network_tpu_torch.signal.msequence import msequence_bytes

        for m in (7, 12, 15):
            nat = native.msequence_bytes_native(512, m)
            np.testing.assert_array_equal(msequence_bytes(512, m), nat)
            np.testing.assert_array_equal(jnative.msequence_bytes_native(512, m), nat)

    def test_fill_packets_matches_traffic_source(self):
        from cognitive_radio_network_tpu_torch.runtime.traffic import (
            PACKET_LEN,
            TrafficConfig,
            TrafficSource,
        )

        src = TrafficSource(TrafficConfig())
        py_packets = [src._make_packet() for _ in range(5)]
        nat = native.fill_packets(5, PACKET_LEN, 0, src.base_payload)
        for i in range(5):
            np.testing.assert_array_equal(py_packets[i], nat[i])
            assert native.packet_number(nat[i]) == i
            assert TrafficSource.packet_number(nat[i]) == i

    def test_bit_errors(self, rng):
        a = rng.integers(0, 256, 10000, dtype=np.uint8)
        b = a.copy()
        b[rng.choice(10000, 100, replace=False)] ^= np.uint8(1 << 3)
        assert native.bit_errors(a, b) == 100 == int(np.unpackbits(a ^ b).sum())


# ---------------- spill, read-back and export ----------------


def _link_scenario(pkg, run_time=0.05):
    """tests/test_runtime.py::_link_scenario: two nodes, FDD, 1 MS/s each way."""
    common = dict(tx_rate=1e6, rx_rate=1e6, tx_gain=20.0, rx_gain=20.0, tx_gain_soft=-6.0,
                  ce_timeout_ms=1000.0, net_mean_throughput=200e3)
    return pkg.ScenarioConfig(
        num_nodes=2, run_time=run_time,
        nodes=[pkg.NodeConfig(tx_freq=464e6, rx_freq=466e6, **common),
               pkg.NodeConfig(tx_freq=466e6, rx_freq=464e6, **common)],
        medium_rate=4e6, medium_center=465e6, medium_block_len=16384, medium_noise_power=1e-7,
        name="two_node_link",
    )


@pytest.fixture(scope="module")
def spills(tmp_path_factory):
    """The link scenario spilled by each package's runtime: (port dir, port
    sink, JAX dir)."""
    base = tmp_path_factory.mktemp("spill")
    port_sink = tlog.LogSink(spill_dir=base / "port")
    trt.ScenarioRuntime(_link_scenario(trt), port_sink, device="cpu").run()
    port_sink.close()
    jax_sink = jlog.LogSink(spill_dir=base / "jax")
    jrt.ScenarioRuntime(_link_scenario(jrt), jax_sink).run()
    jax_sink.close()
    return base / "port", port_sink, base / "jax"


# the receiver's float32 measurements: two FFT libraries round the last bits
# differently (PERF.md, PR 5: EVM differs by an ulp between batch sizes too)
_MEASURED = {"evm_dB": 1e-5, "rssi_dB": 1e-5, "cfo": 1e-9}


def test_spill_reproduces_the_in_memory_records(spills):
    port_dir, sink, _ = spills
    streams = tlog.read_binlog_dir(port_dir)
    assert sorted(streams) == ["net_rx", "net_tx", "phy_rx", "phy_tx"]
    for name in streams:
        mem = getattr(sink, name)
        assert len(mem) == len(streams[name]) > 0
        for m, d in zip(mem, streams[name]):
            for k, v in m.items():
                want = v if not isinstance(v, float) else pytest.approx(v, rel=1e-6, abs=1e-12)
                assert d[k] == want, (name, k)


def test_spill_equals_the_jax_runtimes(spills):
    port_dir, _, jax_dir = spills
    got, want = tlog.read_binlog_dir(port_dir), jlog.read_binlog_dir(jax_dir)
    assert {k: len(v) for k, v in got.items()} == {k: len(v) for k, v in want.items()}
    for name in got:
        for g, w in zip(got[name], want[name]):
            exact = {k: v for k, v in g.items() if not (name == "phy_rx" and k in _MEASURED)}
            assert exact == {k: w[k] for k in exact}, name
            if name == "phy_rx":
                for k, atol in _MEASURED.items():
                    assert g[k] == pytest.approx(w[k], rel=1e-6, abs=atol), k


@pytest.mark.parametrize("which", ["port", "jax"])
def test_either_packages_files_read_equal_in_both(spills, which):
    d = spills[0] if which == "port" else spills[2]
    assert tlog.read_binlog_dir(d) == jlog.read_binlog_dir(d)
    for f in sorted(d.glob("*.crnl")):
        assert tlog.read_binlog(f) == jlog.read_binlog(f)


@pytest.mark.parametrize("which", ["port", "jax"])
def test_export_equals_jax_export(spills, tmp_path, which):
    d = spills[0] if which == "port" else spills[2]
    assert port_cli(["export", str(d), "-o", str(tmp_path / "port.m")]) == 0
    assert jax_cli(["export", str(d), "-o", str(tmp_path / "jax.m")]) == 0
    text = (tmp_path / "port.m").read_text()
    assert text == (tmp_path / "jax.m").read_text()
    assert "phy_tx_tx_freq = [" in text and "net_tx_packet_num = [" in text
    one = d / "phy_tx.crnl"
    assert port_cli(["export", str(one), "-o", str(tmp_path / "p1.m")]) == 0
    assert jax_cli(["export", str(one), "-o", str(tmp_path / "j1.m")]) == 0
    assert (tmp_path / "p1.m").read_text() == (tmp_path / "j1.m").read_text()


def test_export_of_npz_equals_jax_export(spills, tmp_path):
    _, sink, _ = spills
    sink.save_npz(tmp_path / "run.npz")
    assert port_cli(["export", str(tmp_path / "run.npz"), "-o", str(tmp_path / "p.m")]) == 0
    assert jax_cli(["export", str(tmp_path / "run.npz"), "-o", str(tmp_path / "j.m")]) == 0
    assert (tmp_path / "p.m").read_text() == (tmp_path / "j.m").read_text()


def test_phy_rx_strings_survive_the_packed_layout(tmp_path):
    sink = tlog.LogSink(spill_dir=tmp_path)
    rec = {"node": 2, "t": 1.25, "frame_num": 77, "frame_type": 1, "header_valid": 1,
           "payload_valid": 0, "evm_dB": -22.5, "rssi_dB": -40.0, "cfo": 0.001,
           "num_framesyms": 9, "mod_scheme": "qam16", "crc": "crc32", "fec0": "h128",
           "fec1": "v27"}
    sink._spill("phy_rx", rec)
    sink.flush()  # on disk before close: the crash-recovery role
    assert jlog.read_binlog(tmp_path / "phy_rx.crnl")[1][0]["fec1"] == "v27"
    sink.close()
    stream, recs = tlog.read_binlog(tmp_path / "phy_rx.crnl")
    assert stream == "phy_rx"
    assert recs[0]["mod_scheme"] == "qam16" and recs[0]["frame_num"] == 77
    assert recs[0]["evm_dB"] == pytest.approx(-22.5)


# ---------------- the sense CLI's native ingest ----------------


@pytest.fixture
def capture(tmp_path):
    """2 x 16 cycles of a PU scene that hops every cycle."""
    trace = np.arange(32) % 3
    iq = tscene.synthesize_scene(
        torch.Generator().manual_seed(11),
        tscene.occupancy_to_powers(torch.from_numpy(trace), 3, power=0.05),
        5120,
        as_planes=True,
    )
    cap = tmp_path / "cap.iq"
    with tiq.IQWriter(cap, 13e6, 833e6) as w:
        w.write(iq.numpy().reshape(-1, 2))
    return trace, cap


def test_sense_cli_native_ingest_equals_python_reader_and_jax(capture, tmp_path, monkeypatch,
                                                              capsys):
    trace, cap = capture
    args = ["sense", str(cap), "-c", "16", "--device", "cpu"]
    assert port_cli(args + ["-o", str(tmp_path / "native.npz")]) == 0
    assert "through the native prefetcher" in capsys.readouterr().out
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        assert port_cli(args + ["-o", str(tmp_path / "python.npz")]) == 0
    assert "through the Python reader" in capsys.readouterr().out
    assert jax_cli(["sense", str(cap), "-c", "16", "-o", str(tmp_path / "jax.npz")]) == 0
    with np.load(tmp_path / "native.npz") as a, np.load(tmp_path / "python.npz") as b, \
            np.load(tmp_path / "jax.npz") as j:
        for k in ("decision", "features", "tx_freq"):
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a["decision"], trace + 1)
        np.testing.assert_array_equal(a["decision"], j["decision"])
        np.testing.assert_allclose(a["features"], j["features"], rtol=1e-4)
        np.testing.assert_array_equal(a["tx_freq"], j["tx_freq"])


def test_sense_cli_native_cursor_resumes(capture, tmp_path):
    _, cap = capture
    cursor = tmp_path / "cursor.json"
    args = ["sense", str(cap), "-c", "16", "--device", "cpu", "--cursor", str(cursor)]
    assert port_cli(args) == 0
    assert tiq.StreamCursor.load(cursor).sample_index == 32 * 5120
    assert port_cli(args) == 1  # the cursor at the end: nothing left to sense
