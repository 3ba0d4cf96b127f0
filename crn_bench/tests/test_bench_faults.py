"""``correct`` comes out false for the control and for each fault a cell can have.

Each test drives a whole run on the CPU at the small sizes of ``conftest.py``
(the harness's look for a card skipped) with the timed path broken
underneath, or with the control in the program's place.  The control's
readings at the cells' own sizes on the card, and the limits set from them,
are in PERF.md.
"""

import pytest

from crn_bench.tests.conftest import rehearse

SENSE = ("predictive_model.sense_bulk", "predictive_model.quiet_period")
RX = ("eight_node.rx_stream", "predictive_model.rx_stream")


def _run(cell):
    return rehearse(cell)


@pytest.mark.parametrize("cell", SENSE + RX)
def test_sound_run_is_correct(cell):
    assert _run(cell)["correct"] is True


@pytest.mark.parametrize("cell", SENSE + RX)
def test_control_is_not_correct(cell):
    r = rehearse(cell, control=True)
    assert r["correct"] is False
    assert any(v["value"] > v["limit"] for v in r["checks"].values())


def _sense_fault(kind):
    from cognitive_radio_network_tpu_torch.models import sense

    orig = sense.sense_classify

    def broken(iq, params, cfg=sense.SenseConfig()):
        if kind == "half_mean":  # half of each cycle's buffers left out, the mean over the rest
            a, n = cfg.averaging, cfg.fft_length
            iq = tuple(v.reshape(-1, a, n).clone() for v in iq)
            for v in iq:
                v[:, a // 2:] = v[:, : a - a // 2]
            iq = tuple(v.reshape(-1, n) for v in iq)
        out = orig(iq, params, cfg)
        if kind == "altered":  # the first cycle's decision altered where it is produced
            out = dict(out)
            out["decision"] = out["decision"].clone()
            out["decision"][0] = (out["decision"][0] + 1) % 4
        return out

    return sense, broken


@pytest.mark.parametrize("kind", ["altered", "half_mean"])
@pytest.mark.parametrize("cell", SENSE)
def test_sense_faults_are_not_correct(cell, kind, monkeypatch):
    mod, broken = _sense_fault(kind)
    monkeypatch.setattr(mod, "sense_classify", broken)
    assert _run(cell)["correct"] is False


def _rx_fault(kind):
    from cognitive_radio_network_tpu_torch.phy.stream import StreamReceiver

    orig = StreamReceiver.process
    seen = [0]

    def broken(self, iq, threshold=0.2):
        frames = orig(self, iq, threshold)
        if kind == "unchanged":  # a receiver that delivers nothing
            return []
        if kind == "half":  # every second frame left out (a call may deliver one or none)
            kept = [f for i, f in enumerate(frames, seen[0]) if i % 2 == 1]
            seen[0] += len(frames)
            return kept
        for f in frames:  # a payload byte altered where it is produced
            f["payload"] = f["payload"].copy()
            f["payload"][0] ^= 1
        return frames

    return StreamReceiver, broken


@pytest.mark.parametrize("kind", ["altered", "half", "unchanged"])
@pytest.mark.parametrize("cell", RX)
def test_rx_faults_are_not_correct(cell, kind, monkeypatch):
    cls, broken = _rx_fault(kind)
    monkeypatch.setattr(cls, "process", broken)
    r = _run(cell)
    assert r["correct"] is False
    assert r["failed"] > 0

