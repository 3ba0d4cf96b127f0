"""A continuous wideband stream: ``make_wideband_fn(cfg, continuous=True)``.

On the CPU (the kernel's plain version and the packed plain path): any split
of a stream into calls of whole cycles gives the energies and decisions of
one call over the whole stream; the port agrees with the benchmark's float64
channelizer (``crn_bench/reference/wideband.py``, written from the
description, not from the port) across two consecutive blocks; ``reset``
returns to rest; another batch shape raises; the default still starts every
call from rest; the tail helper gives each path's history; the spans and
counters are recorded.

Tolerances: a split against the whole stream, energies within rtol 1e-6 and
decisions equal: the same float32 operations on the same rows, though a
matrix product over fewer rows may sum in other blocks on another BLAS.
Against the float64 reference, energies within 1e-5 of their cycle's mean
channel energy and noise floors within rtol 1e-5: an 8-term float32 FIR, a
float32 DFT and a mean of 128 powers round at a few 1e-7, and the taps are
held in float32 (6e-8); decisions equal where the reference's energy lies
more than 1% from the threshold.
"""

import pytest
import torch

from cognitive_radio_network_tpu_torch.ops.fused_wideband import (
    detect_rule,
    tail_rows,
    wideband_detect_fused,
)
from cognitive_radio_network_tpu_torch.parallel.wideband import (
    WidebandConfig,
    _history,
    make_wideband_fn,
    wideband_sense,
)
from cognitive_radio_network_tpu_torch.utils import profiling
from crn_bench.reference.wideband import wideband_reference

SPLITS = [[7], [3, 4], [1, 2, 4], [1, 1, 2, 1, 2]]


def _stream(lead, cycles, block_len, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*lead, cycles * block_len * 64, 2, generator=g)


def _split_calls(fn, x, splits, block_len, form):
    outs, c0 = [], 0
    n = block_len * 64
    for c in splits:
        part = x[..., c0 * n:(c0 + c) * n, :]
        outs.append(fn((part[..., 0], part[..., 1]) if form == "planar" else part))
        c0 += c
    return {k: torch.cat([o[k] for o in outs], dim=-2) for k in outs[0]}


@pytest.mark.parametrize("use_fused", [None, False])
@pytest.mark.parametrize("form", ["planes", "planar"])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("splits", SPLITS)
def test_any_split_equals_one_call(splits, batch, form, use_fused):
    block_len = 6 if batch == 3 else 128  # calls shorter than the carried 8 rows, and whole cycles
    cfg = WidebandConfig(block_len=block_len)
    x = _stream((batch,), sum(splits), block_len, seed=batch)
    whole = make_wideband_fn(cfg, device="cpu")(x)
    fn = make_wideband_fn(cfg, continuous=True, device="cpu")
    got = _split_calls(lambda p: fn(p, use_fused=use_fused), x, splits, block_len, form)
    torch.testing.assert_close(got["energy"], whole["energy"], rtol=1e-6, atol=0.0)
    torch.testing.assert_close(got["noise"], whole["noise"], rtol=1e-6, atol=0.0)
    assert torch.equal(got["occupied"], whole["occupied"])


def test_matches_the_float64_reference_across_blocks():
    cfg = WidebandConfig()
    wb = {"num_channels": 64, "taps_per_channel": 8, "block_len": 128, "threshold_ratio": 4.0}
    x = _stream((2,), 12, 128, seed=5)
    x[..., : 6 * 128 * 64 // 2, :] *= 3.0  # energies that differ across the blocks' cycles
    blocks = [x[:, : 6 * 128 * 64], x[:, 6 * 128 * 64:]]
    fn = make_wideband_fn(cfg, continuous=True, device="cpu")
    for b, planes in enumerate(blocks):
        got = fn(planes)
        ref = wideband_reference(planes, None if b == 0 else blocks[0], wb)
        gap = (got["energy"].double() - ref["energy"]).abs() / ref["energy"].mean(-1, keepdim=True)
        assert float(gap.max()) < 1e-5
        torch.testing.assert_close(got["noise"].double(), ref["noise"], rtol=1e-5, atol=0.0)
        thr = 4.0 * ref["noise"]
        clear = (ref["energy"] - thr).abs() > 0.01 * thr
        assert torch.equal(got["occupied"][clear], ref["occupied"][clear])
    # from rest in the second block, the first cycle's energies are the reference's no more
    rest = make_wideband_fn(cfg, device="cpu")(blocks[1])
    ref = wideband_reference(blocks[1], blocks[0], wb)
    assert float(((rest["energy"][:, 0].double() - ref["energy"][:, 0]).abs()
                  / ref["energy"][:, 0].mean(-1, keepdim=True)).max()) > 1e-3


def test_reset_returns_to_rest_and_the_batch_shape_is_fixed():
    cfg = WidebandConfig(block_len=8)
    x = _stream((2,), 4, 8, seed=1)
    rest = make_wideband_fn(cfg, device="cpu")(x)
    fn = make_wideband_fn(cfg, continuous=True, device="cpu")
    assert torch.equal(fn(x)["energy"], rest["energy"])  # the first call starts from rest
    again = fn(x)
    assert not torch.equal(again["energy"][:, 0], rest["energy"][:, 0])  # it continues
    assert torch.equal(again["energy"][:, 1:], rest["energy"][:, 1:])
    with pytest.raises(ValueError, match="batch shape"):
        fn(x[:1])
    with pytest.raises(ValueError, match="batch shape"):
        fn(x[0])
    fn.reset()
    assert torch.equal(fn(x[0])["energy"], rest["energy"][0])  # other streams, from rest
    fn.reset()
    assert torch.equal(fn(x)["energy"], rest["energy"])


def test_default_starts_every_call_from_rest():
    cfg = WidebandConfig()
    x = _stream((2,), 3, 128, seed=2)
    fn = make_wideband_fn(cfg, device="cpu")
    first, second = fn(x), fn(x)
    want = wideband_sense(x, torch.from_numpy(cfg.taps()), cfg)
    for k in want:
        assert torch.equal(first[k], want[k]) and torch.equal(second[k], want[k]), k
    fn.reset()  # nothing to forget
    assert torch.equal(fn(x)["energy"], want["energy"])


def test_continuous_over_a_mesh_is_not_supported():
    with pytest.raises(NotImplementedError):
        make_wideband_fn(WidebandConfig(), continuous=True, mesh=object(), device="cpu")


@pytest.mark.parametrize("form", ["planes", "planar"])
def test_tail_rows_give_each_paths_history(form):
    m = 64
    x = _stream((3,), 2, 8, seed=3)
    streams = (x[..., 0].contiguous(), x[..., 1].contiguous()) if form == "planar" else x
    tail = tail_rows(streams, m, 8)
    assert tail.shape == (3, 2, 8, m)
    last = x[:, -8 * m:]  # the last 512 wide samples
    hist_r, hist_i = _history(tail, True, 8)  # kernel 3's 4 pair rows a plane
    assert torch.equal(hist_r, last[..., 0].reshape(3, 4, 2 * m))
    assert torch.equal(hist_i, last[..., 1].reshape(3, 4, 2 * m))
    plain = _history(tail, False, 8)  # the plain FIR's last P-1 phase rows, real then imaginary
    rows = last[:, m:].reshape(3, 7, m, 2)
    assert torch.equal(plain, torch.cat([rows[..., 0], rows[..., 1]], dim=-1))
    assert torch.equal(_history(tail_rows(streams, m, 7), False, 8), plain)


@pytest.mark.parametrize("use_fused", [None, False])
def test_spans_and_counters(use_fused):
    # the fused path decides in the kernel's launch (its plain version here):
    # no decide span of its own
    decide = [] if use_fused is None else ["wideband.decide"]
    cfg = WidebandConfig(block_len=8)
    x = _stream((3,), 2, 8, seed=4)
    fn = make_wideband_fn(cfg, continuous=True, device="cpu")
    with profiling.recording() as recs:
        fn(x, use_fused=use_fused)
        fn(x, use_fused=use_fused)
    tops = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in tops] == ["wideband.call", "wideband.call"]
    for top, carried in zip(tops, (0, 3)):
        kids = [r["name"] for r in recs if r["parent"] == top["index"]]
        assert kids == ["wideband.place", "wideband.energy", *decide, "wideband.carry"]
        assert top["counts"] == {"wideband.cycles": 3 * 2, "wideband.carried_streams": carried}
    calls = profiling.calls(recs)
    assert [c["counts"]["wideband.carried_streams"] for c in calls] == [0, 3]
    with profiling.recording() as recs:
        make_wideband_fn(cfg, device="cpu")(x, use_fused=use_fused)
    (top,) = [r for r in recs if r["parent"] is None]
    assert top["counts"] == {"wideband.cycles": 6}
    assert [r["name"] for r in recs if r["parent"] == top["index"]] == [
        "wideband.place", "wideband.energy", *decide]


@pytest.mark.parametrize("rows", [2, 8, 24])
@pytest.mark.parametrize("form", ["planes", "planar"])
def test_detect_writes_the_tail_the_next_part_takes(rows, form):
    # streams of 2 rows take the rest of their tail from the history before them
    cfg = WidebandConfig(block_len=2)
    taps = torch.from_numpy(cfg.taps())
    x = _stream((3,), rows // 2, 2, seed=6)
    streams = (x[..., 0].contiguous(), x[..., 1].contiguous()) if form == "planar" else x
    g = torch.Generator().manual_seed(7)
    hist = tuple(torch.randn(3, 4, 128, generator=g) for _ in range(2))
    tail = tuple(torch.full((3, 4, 128), float("nan")) for _ in range(2))
    got = wideband_detect_fused(streams, taps, cfg, initial_history=hist, tail_out=tail)
    before = torch.stack([h.reshape(3, 8, 64) for h in hist], dim=1)
    want = torch.cat([before, tail_rows(streams, 64, rows)], dim=-2)[..., -8:, :]
    assert torch.equal(torch.stack(tail, dim=1).reshape(3, 2, 8, 64), want)
    noise, occupied = detect_rule(got["energy"], cfg.threshold_ratio)
    assert torch.equal(got["noise"], noise) and torch.equal(got["occupied"], occupied)
