"""The benchmark's input makers: the same seed gives the same inputs, another seed other ones."""

import numpy as np
import torch

from crn_bench import harness
from crn_bench.reference.link import PACKET_LEN, link_snr_db, make_tape, packet_interval_s
from crn_bench.reference.sense import make_scene


def _config(name):
    return harness.load_json(harness.BENCH / "configs" / f"{name}.json")


def _scene(seed):
    cfg = _config("predictive_model")
    gen = torch.Generator().manual_seed(seed)
    return make_scene(gen, 8, cfg["sense"], cfg["scene"])


def test_scene_is_deterministic_per_seed():
    a, b, c = _scene(2**31 + 5), _scene(2**31 + 5), _scene(2**31 + 6)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (80, 512) and a[0].dtype == torch.float32


def _tape(config, seed):
    cfg = _config(config)
    return make_tape(cfg["links"][0], cfg["medium"], 50_000, np.random.default_rng([seed, 3]))


def test_tapes_are_deterministic_per_seed():
    for config in ("eight_node", "predictive_model"):
        a, b, c = _tape(config, 11), _tape(config, 11), _tape(config, 12)
        assert np.array_equal(a.samples, b.samples) and np.array_equal(a.payloads, b.payloads)
        assert not np.array_equal(a.payloads, c.payloads)
        # every seed: the same sizes and spacing, another phase and other bytes
        assert len(a.samples) == len(c.samples) and len(a.starts) == len(c.starts)
        gaps = np.diff(np.sort(a.starts))
        assert len(set(gaps.tolist())) == 1 and len(a.samples) == gaps[0] * len(a.starts)


def test_pacing_and_snr():
    assert packet_interval_s(1e6) == PACKET_LEN * 8 / 1e6  # 2.048 ms
    eight = _config("eight_node")
    pred = _config("predictive_model")
    assert abs(link_snr_db(eight["links"][0], eight["medium"]) - 77.89) < 0.01
    assert abs(link_snr_db(pred["links"][0], pred["medium"]) - 82.89) < 0.01
    # both: 1 Mb/s outruns the frame, so frames follow back to back
    for config, flen in (("eight_node", 4864), ("predictive_model", 6304)):
        t = _tape(config, 1)
        assert np.diff(np.sort(t.starts))[0] == t.layout.frame_len == flen
