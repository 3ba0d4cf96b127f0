"""Kernel 3 at a sensing period of ``wideband64``, its decisions, and continuous calls on the card.

These tests need a CUDA card and skip without one (the condition is a string,
evaluated when each test runs, so every worker collects the same tests).
Run them on a GPU machine with:

    python -m pytest tests/test_torch_cuda_wideband_continuous.py -m cuda --noconftest -q

48 streams x 20,480 rows (160 cycles of 128) with a history per stream: the
kernel within rtol 1e-5, atol 1e-7 of its plain version at "highest" (both
float32, an FFT against a matrix product; the bound of the other kernel 3
tests).  ``make_wideband_fn(cfg, continuous=True)`` over calls of any split
gives one call's bits over the whole stream (the kernel's sums depend on a
cycle's rows alone, and the carried rows are the rows before), on planes
and planar streams alike, and one kernel launch a call.

The kernel's own decisions: its energies are the energy-only launch's bits,
its noise floors within rtol 4e-6 of ``detect_rule`` on those energies (a
float32 sum of 64 positive terms in another order: at most 64 roundings of
6e-8), its decisions the threshold on its own floors exactly, and the tail
it writes the stream's last 8 rows as bits (the history's before a stream
of fewer rows).
"""

import pytest
import torch

from cognitive_radio_network_tpu_torch.ops.fused_wideband import (
    detect_rule,
    tail_rows,
    wideband_detect_fused,
    wideband_energy_fused,
    wideband_energy_fused_planes,
    wideband_energy_fused_plain,
)
from cognitive_radio_network_tpu_torch.parallel.wideband import WidebandConfig, make_wideband_fn

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card"),
]

STREAMS, ROWS = 48, 20_480


def _planes(streams, rows, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(streams, rows * 64, 2, generator=g, device="cuda")


def test_kernel_with_history_at_the_deployments_shape():
    cfg = WidebandConfig()
    taps = torch.from_numpy(cfg.taps()).cuda()
    planes = _planes(STREAMS, ROWS, 1)
    g = torch.Generator(device="cuda").manual_seed(2)
    hist = tuple(torch.randn(STREAMS, 4, 128, generator=g, device="cuda") for _ in range(2))
    before = wideband_energy_fused.launches
    got = wideband_energy_fused_planes(planes, taps, cfg, initial_history=hist)
    assert wideband_energy_fused.launches == before + 1
    xr, xi = planes[..., 0].contiguous(), planes[..., 1].contiguous()
    want = wideband_energy_fused_plain(xr, xi, taps, cfg, precision="highest", initial_history=hist)
    assert got.shape == (STREAMS, ROWS // 128, 64)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
    assert torch.equal(wideband_energy_fused(xr, xi, taps, cfg, initial_history=hist), got)


@pytest.mark.parametrize("splits", [[160], [60, 100], [1, 159], [3, 77, 80]])
@pytest.mark.parametrize("form", ["planes", "planar"])
def test_continuous_calls_give_the_whole_streams_bits(splits, form):
    cfg = WidebandConfig()
    planes = _planes(STREAMS, 2 * ROWS, 3)
    whole = make_wideband_fn(cfg)(planes)
    fn = make_wideband_fn(cfg, continuous=True)
    outs, c0 = [], 0
    n = 128 * 64
    for c in splits + splits:  # two blocks, split alike
        part = planes[:, c0 * n:(c0 + c) * n]
        before = wideband_energy_fused.launches
        outs.append(fn((part[..., 0].contiguous(), part[..., 1].contiguous()) if form == "planar"
                       else part))
        assert wideband_energy_fused.launches == before + 1
        c0 += c
    for k in whole:
        assert torch.equal(torch.cat([o[k] for o in outs], dim=1), whole[k]), k
    fn.reset()
    assert torch.equal(fn(planes)["energy"], whole["energy"])


@pytest.mark.parametrize("form", ["planes", "planar"])
def test_kernel_decides_and_writes_the_tail(form):
    cfg = WidebandConfig()
    taps = torch.from_numpy(cfg.taps()).cuda()
    planes = _planes(STREAMS, ROWS, 4)
    # a tone in channel 5 over the first half of the rows: decisions both ways
    n = torch.arange(ROWS * 32, device="cuda", dtype=torch.float64)
    ph = 2 * torch.pi * ((5 * n) % 64) / 64
    planes[:, : ROWS * 32] += 3.0 * torch.stack([ph.cos(), ph.sin()], dim=-1).float()
    streams = planes if form == "planes" else (planes[..., 0].contiguous(), planes[..., 1].contiguous())
    g = torch.Generator(device="cuda").manual_seed(5)
    hist = tuple(torch.randn(STREAMS, 4, 128, generator=g, device="cuda") for _ in range(2))
    tail = tuple(torch.full((STREAMS, 4, 128), float("nan"), device="cuda") for _ in range(2))
    before = wideband_energy_fused.launches
    got = wideband_detect_fused(streams, taps, cfg, initial_history=hist, tail_out=tail)
    assert wideband_energy_fused.launches == before + 1
    assert torch.equal(got["energy"], wideband_energy_fused_planes(planes, taps, cfg, initial_history=hist))
    noise, _ = detect_rule(got["energy"], cfg.threshold_ratio)
    torch.testing.assert_close(got["noise"], noise, rtol=4e-6, atol=0.0)
    assert torch.equal(got["occupied"], got["energy"] > cfg.threshold_ratio * got["noise"])
    assert bool(got["occupied"].any()) and not bool(got["occupied"].all())
    assert torch.equal(torch.stack(tail, dim=1).reshape(STREAMS, 2, 8, 64), tail_rows(streams, 64, 8))


@pytest.mark.parametrize("rows", [2, 6])
def test_kernel_tail_of_a_short_stream_takes_the_history(rows):
    cfg = WidebandConfig(block_len=2)
    taps = torch.from_numpy(cfg.taps()).cuda()
    planes = _planes(3, rows, 6)
    g = torch.Generator(device="cuda").manual_seed(7)
    hist = tuple(torch.randn(3, 4, 128, generator=g, device="cuda") for _ in range(2))
    tail = tuple(torch.empty(3, 4, 128, device="cuda") for _ in range(2))
    got = wideband_detect_fused(planes, taps, cfg, initial_history=hist, tail_out=tail)
    want_tail = tuple(torch.empty(3, 4, 128) for _ in range(2))
    want = wideband_detect_fused(planes.cpu(), taps.cpu(), cfg, initial_history=tuple(h.cpu() for h in hist),
                                 tail_out=want_tail)
    for a, b in zip(tail, want_tail):
        assert torch.equal(a.cpu(), b)
    torch.testing.assert_close(got["energy"].cpu(), want["energy"], rtol=1e-5, atol=1e-7)
