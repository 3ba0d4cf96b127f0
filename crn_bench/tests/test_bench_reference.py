"""The plain references agree with the port's plain CPU paths at a tiny size."""

import numpy as np
import torch

from crn_bench import harness
from crn_bench.drivers._sensing import sense_function
from crn_bench.reference.link import make_tape
from crn_bench.reference.phy import FrameLayout, soft_values
from crn_bench.reference.sense import make_scene, sense_reference


def _config(name):
    return harness.load_json(harness.BENCH / "configs" / f"{name}.json")


def test_sense_reference_matches_the_port_on_the_cpu():
    cfg = _config("predictive_model")
    xr, xi = make_scene(torch.Generator().manual_seed(3), 64, cfg["sense"], cfg["scene"])
    ref = sense_reference(xr, xi, cfg["sense"], cfg["mlp"])
    fn, params = sense_function(cfg, "cpu")
    got = fn((xr, xi), params)
    avg = ref["avg_spectrum"]
    assert float(((got["avg_spectrum"].double() - avg).abs() / avg.mean(-1, keepdim=True)).max()) < 1e-4
    assert float(((got["features"].double() - ref["features"]).abs() / ref["features"]).max()) < 1e-4
    assert torch.equal(got["decision"], ref["decision"])
    assert len(set(ref["decision"].tolist())) >= 3  # the scene drives several decisions


def test_sense_reference_matches_the_golden_loops():
    # the CE_Predictive_Node loops restated scalar by scalar (tests/golden_reference.py)
    cfg = _config("predictive_model")
    xr, xi = make_scene(torch.Generator().manual_seed(4), 2, cfg["sense"], cfg["scene"])
    ref = sense_reference(xr, xi, cfg["sense"], cfg["mlp"])
    x = (xr.double() + 1j * xi.double()).numpy().reshape(2, 10, 512)
    for c in range(2):
        avg = np.abs(np.fft.fft(x[c], axis=-1)).mean(0)
        b = lambda lo, hi: avg[lo:hi].sum()  # noqa: E731
        feats = np.array([b(300, 310), b(0, 16) + b(496, 511), b(55, 85), b(189, 222)]) ** 2
        assert np.allclose(ref["features"][c].numpy(), feats, rtol=1e-12)


def test_frames_match_the_port_generator():
    from cognitive_radio_network_tpu_torch.phy.framegen import OFDMFrameConfig, OFDMFrameGen

    for mod, f0, f1 in (("qam4", "h128", "none"), ("qam16", "v27", "v27")):
        phy = dict(num_subcarriers=32, cp_len=16, taper_len=4, mod=mod, fec0=f0, fec1=f1, crc="crc32")
        layout = FrameLayout(phy, 256)
        rng = np.random.default_rng(1)
        h = rng.integers(0, 256, (2, 8), dtype=np.uint8)
        p = rng.integers(0, 256, (2, 256), dtype=np.uint8)
        port = OFDMFrameGen(OFDMFrameConfig(mod_scheme=mod, fec0=f0, fec1=f1), 256)
        assert layout.frame_len == port.frame_len
        assert np.abs(layout.frames(h, p) - port.assemble(h, p, device="cpu").numpy()).max() < 1e-5


def test_soft_values_match_the_port_receiver_on_the_cpu():
    from cognitive_radio_network_tpu_torch.phy.framegen import OFDMFrameConfig
    from cognitive_radio_network_tpu_torch.phy.stream import StreamReceiver

    cfg = _config("eight_node")
    tape = make_tape(cfg["links"][0], cfg["medium"], 60_000, np.random.default_rng(5))
    rx = StreamReceiver(OFDMFrameConfig(), max_frames_per_block=64, device="cpu")
    got = []
    for b in range(len(tape.samples) // 16384):
        got += rx.process(tape.samples[b * 16384:(b + 1) * 16384])
    assert len(got) >= 4
    starts = {int(s): j for j, s in enumerate(tape.starts)}
    js = [starts[f["offset"]] for f in got]
    ref = soft_values(tape.layout, np.stack([tape.frame(j) for j in js]))
    for f, j, r in zip(got, js, ref):
        assert np.array_equal(f["payload"], tape.payloads[j]) and f["stats"].payload_valid
        assert abs(f["stats"].cfo - r[0]) < 1e-8
        assert abs(f["stats"].rssi - r[1]) < 1e-4
        assert abs(f["stats"].evm - r[2]) < 0.5
