"""The CUDA kernels of the port against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one (the condition is a string,
evaluated when each test runs, so every worker collects the same tests).
Run them on a GPU machine with (``--noconftest``: tests/conftest.py imports
JAX, which a machine for the port need not have):

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -q

Bounds are those of chip_smoke.py: avg rtol 1e-4, atol 1e-5 and feats rtol
1e-4 for f32 input; feats rtol 2e-2 of the f32 result for bf16 input.
``extract_windows`` and ``extract_window_sets`` are copies: the kernel must
equal the plain version bit for bit (``torch.equal``), into windows it
allocates and into the caller's.  ``wideband_energy_fused``: rtol 1e-5, atol 1e-7
against the plain version at "highest" (both float32, an FFT against a matrix
product); a stream cut in two with the history carried gives the whole
stream's bits, a batch (one launch) its streams' launched one by one, and
interleaved planes the planar ones.  ``fused_band_features``: rtol 1e-4 against the dense plain
version, 1e-6 against ``fused_sense_ct``'s features (the same register FFT in
another kernel: equal or a few ulp), equal from run to run.
``resolve_candidates`` is integers and one float32 compare: ``torch.equal``.
Training on the card: ``make_dataset`` launches the sense kernel once, its
features within rtol 1e-4 of the CPU plain path's; a wideband train step
launches the wideband kernel once for its batch, its loss within rtol 1e-5
of the loss over the packed plain path's energies.
"""

import numpy as np
import pytest
import torch

from cognitive_radio_network_tpu_torch.models import SenseConfig, make_sense_fn
from cognitive_radio_network_tpu_torch.models.distributed import make_sharded_apply
from cognitive_radio_network_tpu_torch.ops.extract import (
    extract_window_sets,
    extract_window_sets_plain,
    extract_windows,
    window_buffers,
)
from cognitive_radio_network_tpu_torch.ops.fused_sense import (
    fused_band_features,
    fused_band_features_plain,
)
from cognitive_radio_network_tpu_torch.ops.fused_sense_ct import (
    fused_sense_ct,
    fused_sense_ct_plain,
)
from cognitive_radio_network_tpu_torch.ops.fused_wideband import (
    wideband_energy_fused,
    wideband_energy_fused_plain,
    wideband_energy_fused_planes,
)
from cognitive_radio_network_tpu_torch.ops.resolve import (
    resolve_candidates,
    resolve_candidates_plain,
)
from cognitive_radio_network_tpu_torch.parallel.wideband import WidebandConfig, make_wideband_fn
from cognitive_radio_network_tpu_torch.phy import (
    OFDMFrameConfig,
    OFDMFrameGen,
    OFDMFrameSync,
    StreamReceiver,
)
from cognitive_radio_network_tpu_torch.signal.mlp import OccupancyMLP, reference_weights

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card"),
]


def _planes(c, seed=0, a=10):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(c * a, 512, generator=g, device="cuda") for _ in range(2))


@pytest.mark.parametrize("cycles", [4096, 5, 1])
def test_kernel_matches_plain_f32(cycles):
    xr, xi = _planes(cycles)
    before = fused_sense_ct.launches
    avg, feats = fused_sense_ct(xr, xi)
    assert fused_sense_ct.launches == before + 1
    avg_p, feats_p = fused_sense_ct_plain(xr, xi)  # f32 matmuls, TF32 off
    torch.cuda.synchronize()
    assert avg.shape == (cycles, 512) and feats.shape == (cycles, 4)
    torch.testing.assert_close(avg, avg_p, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(feats, feats_p, rtol=1e-4, atol=0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("averaging", [1, 3, 10])
@pytest.mark.parametrize("cycles", [1, 5, 133, 4096])
def test_kernel_any_cycles_and_averaging_same_from_run_to_run(cycles, averaging, dtype):
    """Any C >= 1 and any A: rows that fill no whole class of four, cycles
    that fill no whole wave of blocks.  bf16 input is upcast exactly, so it is
    held to the plain version on the same bf16 values at the f32 bounds."""
    xr, xi = (v.to(dtype) for v in _planes(cycles, seed=cycles + averaging, a=averaging))
    avg, feats = fused_sense_ct(xr, xi, averaging=averaging)
    again = fused_sense_ct(xr, xi, averaging=averaging)
    avg_p, feats_p = fused_sense_ct_plain(xr, xi, averaging=averaging)
    torch.cuda.synchronize()
    assert avg.shape == (cycles, 512) and feats.shape == (cycles, 4)
    assert torch.equal(avg, again[0]) and torch.equal(feats, again[1])
    torch.testing.assert_close(avg, avg_p, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(feats, feats_p, rtol=1e-4, atol=0.0)


def test_kernel_bf16_input():
    xr, xi = _planes(256, seed=1)
    _, want = fused_sense_ct_plain(xr, xi)
    _, got = fused_sense_ct(xr.bfloat16(), xi.bfloat16(), precision="default")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-2, atol=0.0)


def test_kernel_3d_input_and_other_averaging():
    xr, xi = _planes(6, seed=2, a=4)
    got = fused_sense_ct(xr.reshape(6, 4, 512), xi.reshape(6, 4, 512))
    want = fused_sense_ct_plain(xr, xi, averaging=4)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


def test_kernel_rejects_bad_input():
    xr, xi = _planes(2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_sense_ct(xr.double(), xi.double())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_sense_ct(xr, xi.bfloat16())
    with pytest.raises(ValueError, match="N=512"):
        fused_sense_ct(xr.reshape(40, 256), xi.reshape(40, 256))
    with pytest.raises(ValueError, match="not divisible"):
        fused_sense_ct(xr[:15], xi[:15])
    with pytest.raises(ValueError, match="contiguous"):
        fused_sense_ct(xr.t(), xi.t())
    with pytest.raises(ValueError, match="but xi on cpu"):
        fused_sense_ct(xr, xi.cpu())


def test_main_path_launches_kernel_and_matches_cpu():
    xr, xi = _planes(64, seed=3)
    xr, xi = 0.05 * xr, 0.05 * xi
    fn = make_sense_fn(SenseConfig())
    before = fused_sense_ct.launches
    res = fn((xr, xi), reference_weights(device="cuda"))
    assert fused_sense_ct.launches == before + 1
    cpu = make_sense_fn(SenseConfig(), device="cpu")((xr.cpu(), xi.cpu()), reference_weights())
    assert cpu["decision"].device.type == "cpu"
    assert torch.equal(res["decision"].cpu(), cpu["decision"])
    torch.testing.assert_close(res["features"].cpu(), cpu["features"], rtol=1e-4, atol=0.0)
    # host input and host parameters go to the card by default, and launch the kernel
    params = reference_weights()
    host = fn((xr.cpu().numpy(), xi.cpu().numpy()), params)
    assert fused_sense_ct.launches == before + 2
    assert host["decision"].device.type == "cuda" and params.w1.device.type == "cpu"
    assert torch.equal(host["decision"], res["decision"])
    assert torch.equal(host["features"], res["features"])


LINK_N = 1_265_664  # 256 default-config frames of 4864 samples with 80-sample gaps


def _link_planes(n, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(n, generator=g, device="cuda") for _ in range(2))


STEP_N = 2_056_192  # the adaptive stream step's buffer: residual + one block (chip_smoke.py phase 17)
STEP_WLENS = (688, 4864, 2080)  # its header windows and two speculated configs' frames


@pytest.mark.parametrize(
    "n,k,wlen,lead",
    [
        (LINK_N, 256, 4864, 0),
        (LINK_N, 256, 160, 0),
        (LINK_N, 3, 333, 0),
        (100, 4, 160, 0),
        (5000, 1, 1, 0),
        (STEP_N, 520, STEP_WLENS, 0),
        (STEP_N, 520, STEP_WLENS, 1),
        (STEP_N, 64, (333, 160, 4864, 1), 3),
        (3000, 8, (160, 4864), 2),
        (5000, 0, STEP_WLENS, 0),
        (5000, 16, (0, 688), 1),
    ],
)
def test_extract_kernel_equals_plain(n, k, wlen, lead):
    """The kernel equals the plain version bit for bit.  ``wlen`` a tuple:
    one launch of ``extract_window_sets`` for every set, each clipped for its
    own length (offsets within 4864 of the end clip differently per set).
    ``lead``: the planes start ``lead`` floats into their allocation, so their
    base is not 16-byte aligned unless ``lead % 4 == 0``.  Offsets take every
    residue mod 4; windows are also gathered into caller-owned buffers."""
    rr, ri = (x[lead:] for x in _link_planes(n + lead, seed=k))
    wlens = wlen if isinstance(wlen, tuple) else (wlen,)
    g = torch.Generator(device="cuda").manual_seed(sum(wlens))
    offs = torch.randint(-50, n + 50, (k,), generator=g, device="cuda")
    edge = torch.tensor([-7, n - 3, n + 100, 0, 1, n - max(wlens), 4097, 4098, 4099, 4100,
                         n - 4863, n - 1000, n - 689], device="cuda")
    offs[: min(k, len(edge))] = edge[: min(k, len(edge))]
    for o in (offs, offs.int()):
        before = extract_windows.launches
        got = extract_window_sets(rr, ri, o, wlens)
        assert extract_windows.launches == before + (1 if k and any(wlens) else 0)
        if len(wlens) == 1:
            one = extract_windows(rr, ri, o, wlen)
            assert torch.equal(one[0], got[0][0]) and torch.equal(one[1], got[0][1])
        want = extract_window_sets_plain(rr, ri, o, wlens)
        out = window_buffers(rr, k, wlens)
        into = extract_window_sets(rr, ri, o, wlens, out=out)
        torch.cuda.synchronize()
        for (gr, gi), (wr, wi), (ir, ii), (orr, oi), w in zip(got, want, into, out, wlens):
            assert gr.shape == (k, w) and gr.is_contiguous() and gi.is_contiguous()
            assert torch.equal(gr, wr) and torch.equal(gi, wi)
            assert ir is orr and ii is oi and torch.equal(ir, wr) and torch.equal(ii, wi)


def test_extract_kernel_rejects_bad_input():
    rr, ri = _link_planes(1000)
    offs = torch.zeros(2, dtype=torch.int64, device="cuda")
    with pytest.raises(TypeError, match="float32"):
        extract_windows(rr.double(), ri.double(), offs, 10)
    with pytest.raises(TypeError, match="integers"):
        extract_windows(rr, ri, offs.float(), 10)
    with pytest.raises(ValueError, match="contiguous"):
        extract_windows(rr[::2], ri[::2], offs, 10)
    with pytest.raises(ValueError, match="one card"):
        extract_windows(rr, ri, offs.cpu(), 10)
    with pytest.raises(ValueError, match="expected planes"):
        extract_windows(rr.reshape(10, 100), ri.reshape(10, 100), offs, 10)
    good = torch.empty(2, 10, device="cuda")
    for bad, exc in ((torch.empty(3, 10, device="cuda"), ValueError),
                     (torch.empty(2, 10, device="cuda", dtype=torch.float64), TypeError),
                     (torch.empty(2, 10), ValueError),
                     (torch.empty(10, 2, device="cuda").t(), ValueError)):
        with pytest.raises(exc, match="out"):
            extract_windows(rr, ri, offs, 10, out=(good, bad))
    with pytest.raises(ValueError, match="1 to 4 window lengths"):
        extract_window_sets(rr, ri, offs, (10,) * 5)


def test_link_on_card_launches_kernel_and_matches_cpu():
    cfg, payload_len = OFDMFrameConfig(), 64
    gen, sync = OFDMFrameGen(cfg, payload_len), OFDMFrameSync(cfg, payload_len)
    rng = torch.Generator().manual_seed(5)
    headers = torch.randint(0, 256, (4, 8), generator=rng, dtype=torch.uint8).numpy()
    payloads = torch.randint(0, 256, (4, payload_len), generator=rng, dtype=torch.uint8).numpy()
    frames = gen.assemble(headers, payloads, as_planes=True, device="cuda")
    gap = torch.zeros((4, 80, 2), device="cuda")
    block = torch.cat([frames, gap], dim=1).reshape(-1, 2)
    rr, ri = block[:, 0].contiguous(), block[:, 1].contiguous()
    before = extract_windows.launches
    bests, peaks, cfos, out, ok = sync.rx_block_fn(k=4)(rr, ri, rr.shape[0])
    assert extract_windows.launches == before + 2
    order = torch.argsort(bests).cpu()
    assert bool(ok.all())
    assert (out["payloads"].cpu()[order].numpy() == payloads).all()
    cpu = sync.rx_block_fn(k=4)(rr.cpu(), ri.cpu(), rr.shape[0])
    assert torch.equal(cpu[0].sort().values, bests.cpu().sort().values)
    # host input goes to the card by default: numpy frames decode through the kernel
    assert sync.device.type == "cuda" and gen.assemble(headers, payloads).device.type == "cuda"
    before = extract_windows.launches
    got = sync.receive_block(block.cpu().numpy(), k=4)
    assert extract_windows.launches == before + 2
    assert [f["offset"] for f in got] == [i * (gen.frame_len + 80) for i in range(4)]


@pytest.mark.parametrize("form", ["complex", "planes", "planar-views"])
def test_receive_block_on_card_takes_each_iq_form(form):
    """receive_block straight from ``assemble(device="cuda")``: the complex
    block, its (N, 2) planes and a tuple of their strided views all reach
    the kernel and decode every frame."""
    cfg, payload_len = OFDMFrameConfig(), 64
    gen, sync = OFDMFrameGen(cfg, payload_len), OFDMFrameSync(cfg, payload_len, device="cuda")
    rng = torch.Generator().manual_seed(6)
    headers = torch.randint(0, 256, (3, 8), generator=rng, dtype=torch.uint8).numpy()
    payloads = torch.randint(0, 256, (3, payload_len), generator=rng, dtype=torch.uint8).numpy()
    iq = gen.assemble(headers, payloads, device="cuda")  # (3, frame_len) complex64
    iq = torch.cat([iq, torch.zeros((3, 80), dtype=iq.dtype, device="cuda")], dim=1).reshape(-1)
    block = {
        "complex": iq,
        "planes": torch.view_as_real(iq),
        "planar-views": (torch.view_as_real(iq)[:, 0], torch.view_as_real(iq)[:, 1]),
    }[form]
    before = extract_windows.launches
    frames = sync.receive_block(block, k=4)
    assert extract_windows.launches == before + 2
    assert [f["offset"] for f in frames] == [i * (gen.frame_len + 80) for i in range(3)]
    for f, h, p in zip(frames, headers, payloads):
        assert (f["header"] == h).all() and (f["payload"] == p).all()
        assert f["stats"].payload_valid


def _wide(t, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(t * 64, generator=g, device="cuda") for _ in range(2))


@pytest.mark.parametrize(
    "t,block_len", [(524288, 128), (1280, 128), (128, 128), (60, 6), (100, 20), (64, 2)]
)
def test_wideband_kernel_matches_plain(t, block_len):
    cfg = WidebandConfig(block_len=block_len, precision="highest")
    xr, xi = _wide(t, seed=block_len)
    before = wideband_energy_fused.launches
    got = wideband_energy_fused(xr, xi, cfg.taps(), cfg, precision="highest")
    assert wideband_energy_fused.launches == before + 1
    want = wideband_energy_fused_plain(xr, xi, cfg.taps(), cfg, precision="highest")
    torch.cuda.synchronize()
    assert got.shape == (t // block_len, 64)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


def test_wideband_kernel_history_and_split_stream():
    cfg = WidebandConfig()
    taps = torch.from_numpy(cfg.taps()).cuda()
    xr, xi = _wide(4096, seed=1)
    hist = tuple(h.reshape(4, 128).contiguous() for h in _wide(8, seed=2))
    got = wideband_energy_fused(xr, xi, taps, cfg, initial_history=hist)
    want = wideband_energy_fused_plain(xr, xi, taps, cfg, precision="highest", initial_history=hist)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
    rest = wideband_energy_fused(xr, xi, taps, cfg)
    assert not torch.equal(got[0], rest[0]) and torch.equal(got[1:], rest[1:])
    h = 2048 * 64
    first = wideband_energy_fused(xr[:h], xi[:h], taps, cfg)
    carry = (xr[h - 512 : h].reshape(4, 128), xi[h - 512 : h].reshape(4, 128))
    second = wideband_energy_fused(xr[h:], xi[h:], taps, cfg, initial_history=carry)
    assert torch.equal(torch.cat([first, second]), rest)
    assert torch.equal(wideband_energy_fused(xr, xi, taps, cfg), rest)  # the same from run to run


@pytest.mark.parametrize("t,block_len", [(4096, 128), (1280, 20), (60, 6), (64, 2)])
def test_wideband_kernel_batch_is_one_launch_equal_to_its_streams(t, block_len):
    """A batch in one launch gives each stream's bits as launched alone, in
    every layout: planar, interleaved planes, complex64; with per-stream
    histories within rtol 1e-5, atol 1e-7 of the plain version."""
    cfg = WidebandConfig(block_len=block_len)
    taps = torch.from_numpy(cfg.taps()).cuda()
    b = 3
    g = torch.Generator(device="cuda").manual_seed(block_len)
    planes = torch.randn(b, t * 64, 2, generator=g, device="cuda")
    hist = tuple(torch.randn(b, 4, 128, generator=g, device="cuda") for _ in range(2))
    xr, xi = planes[..., 0].contiguous(), planes[..., 1].contiguous()
    for h in (None, hist):
        before = wideband_energy_fused.launches
        batch = wideband_energy_fused(xr, xi, taps, cfg, initial_history=h)
        inter = wideband_energy_fused_planes(planes, taps, cfg, initial_history=h)
        cplx = wideband_energy_fused_planes(torch.view_as_complex(planes), taps, cfg, initial_history=h)
        assert wideband_energy_fused.launches == before + 3
        one = torch.stack([
            wideband_energy_fused(xr[i], xi[i], taps, cfg,
                                  initial_history=None if h is None else (h[0][i], h[1][i]))
            for i in range(b)
        ])
        assert batch.shape == (b, t // block_len, 64)
        assert torch.equal(batch, one) and torch.equal(inter, batch) and torch.equal(cplx, batch)
        want = wideband_energy_fused_plain(xr, xi, taps, cfg, precision="highest", initial_history=h)
        torch.testing.assert_close(batch, want, rtol=1e-5, atol=1e-7)
    # B=1 is the unbatched call; the same from run to run
    assert torch.equal(wideband_energy_fused(xr[:1], xi[:1], taps, cfg)[0],
                       wideband_energy_fused(xr[0], xi[0], taps, cfg))
    assert torch.equal(wideband_energy_fused_planes(planes, taps, cfg, initial_history=hist), inter)


def test_wideband_kernel_reads_strided_streams_in_place_and_cuts_the_batch():
    """Evenly spaced streams (a stride of whole rows) and views of a longer
    batch need no copy; a batch cut in time with the tails carried as
    per-stream histories gives the whole batch's bits; empty shapes."""
    cfg = WidebandConfig()
    taps = torch.from_numpy(cfg.taps()).cuda()
    g = torch.Generator(device="cuda").manual_seed(7)
    t = 2048
    wide = torch.randn(4, (t + 256) * 64, 2, generator=g, device="cuda")
    planes = wide[:, : t * 64]  # stream stride (t + 256) rows
    whole = wideband_energy_fused_planes(planes, taps, cfg)
    assert torch.equal(whole, wideband_energy_fused_planes(planes.contiguous(), taps, cfg))
    xr, xi = wide[..., 0].contiguous(), wide[..., 1].contiguous()
    assert torch.equal(whole, wideband_energy_fused(xr[:, : t * 64], xi[:, : t * 64], taps, cfg))
    h = 1024 * 64
    first = wideband_energy_fused_planes(planes[:, :h], taps, cfg)
    tails = planes[:, h - 512 : h].movedim(-1, -2).contiguous().reshape(4, 2, 4, 128)
    second = wideband_energy_fused_planes(planes[:, h:], taps, cfg,
                                          initial_history=(tails[:, 0], tails[:, 1]))
    assert torch.equal(torch.cat([first, second], dim=1), whole)
    assert wideband_energy_fused_planes(planes[:0], taps, cfg).shape == (0, t // 128, 64)
    assert wideband_energy_fused_planes(planes[:, :0], taps, cfg).shape == (4, 0, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        wideband_energy_fused_planes(wide.reshape(-1, 2)[1 : 1 + t * 64], taps, cfg)
    with pytest.raises(ValueError, match="each stream contiguous"):
        wideband_energy_fused_planes(wide[..., :1].expand(-1, -1, 2)[:, : t * 64], taps, cfg)


def test_wideband_kernel_rejects_bad_input():
    cfg = WidebandConfig()
    xr, xi = _wide(256)
    with pytest.raises(TypeError, match="float32"):
        wideband_energy_fused(xr.double(), xi.double(), cfg.taps(), cfg)
    with pytest.raises(ValueError, match="contiguous"):
        wideband_energy_fused(xr[::2], xi[::2], cfg.taps(), cfg)
    with pytest.raises(ValueError, match="16-byte aligned"):
        wideband_energy_fused(xr[1 : 1 + 128 * 64], xi[1 : 1 + 128 * 64], cfg.taps(), cfg)
    with pytest.raises(ValueError, match="one card"):
        wideband_energy_fused(xr, xi.cpu(), cfg.taps(), cfg)
    with pytest.raises(ValueError, match="whole sense cycles"):
        wideband_energy_fused(xr[: 100 * 64], xi[: 100 * 64], cfg.taps(), cfg)
    assert wideband_energy_fused(xr[:0], xi[:0], cfg.taps(), cfg).shape == (0, 64)


def test_wideband_path_launches_kernel_and_matches_cpu():
    cfg = WidebandConfig()
    g = torch.Generator(device="cuda").manual_seed(4)
    t, active = 1024, [3, 17, 40]
    n = torch.arange(t * 64, device="cuda", dtype=torch.float64)
    planes = 1e-3 * torch.randn(t * 64, 2, generator=g, device="cuda")
    for k in active:
        ph = 2 * torch.pi * ((k * n) % 64) / 64
        planes += torch.stack([ph.cos(), ph.sin()], dim=-1).float()
    before = wideband_energy_fused.launches
    res = make_wideband_fn(cfg)(planes)
    assert wideband_energy_fused.launches == before + 1
    want = torch.zeros(64, dtype=torch.bool, device="cuda")
    want[active] = True
    assert bool((res["occupied"][1:] == want).all())
    cpu = make_wideband_fn(cfg, device="cpu")(planes.cpu())
    assert torch.equal(res["occupied"].cpu(), cpu["occupied"])
    torch.testing.assert_close(res["noise"].cpu(), cpu["noise"], rtol=1e-4, atol=1e-9)
    batch = torch.stack([planes, planes.flip(0)])
    mlp = OccupancyMLP(4, 5, 1, device="cuda")
    with torch.no_grad():
        mlp.w1.normal_(generator=g)
        mlp.w2.normal_(generator=g)
    before = wideband_energy_fused.launches
    probs = make_sharded_apply(cfg)(mlp, batch)
    assert wideband_energy_fused.launches == before + 1  # one launch for the batch
    assert probs.shape == (2, t // 128, 64)
    assert bool(((probs > 0) & (probs < 1)).all())
    # the batch through the kernel in one launch against the packed plain path
    fn = make_wideband_fn(cfg)
    fused, packed = fn(batch), fn(batch, use_fused=False)
    assert wideband_energy_fused.launches == before + 2
    assert torch.equal(fused["energy"][0], res["energy"])
    # complex input is read in place too, with the same bits
    assert torch.equal(fn(torch.view_as_complex(batch))["energy"], fused["energy"])
    torch.testing.assert_close(fused["energy"], packed["energy"], rtol=1e-5, atol=1e-7)
    assert torch.equal(fused["occupied"], packed["occupied"])


@pytest.mark.parametrize("cycles,averaging", [(4096, 10), (5, 10), (1, 10), (3, 100), (20, 1), (7, 3)])
def test_dense_sense_kernel_matches_plain(cycles, averaging):
    xr, xi = _planes(cycles, seed=averaging, a=averaging)
    before = fused_band_features.launches
    got = fused_band_features((xr, xi), averaging=averaging)
    assert fused_band_features.launches == before + 1
    want = fused_band_features_plain((xr, xi), averaging=averaging)
    torch.cuda.synchronize()
    assert got.shape == (cycles, 4)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0.0)
    _, ct = fused_sense_ct(xr, xi, averaging=averaging)
    torch.testing.assert_close(got, ct, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("averaging", [1, 3, 10])
@pytest.mark.parametrize("cycles", [1, 5, 133, 4096])
def test_dense_sense_kernel_same_from_run_to_run_and_whatever_c(cycles, averaging):
    """Equal bits from run to run, and a cycle's bits do not depend on how many
    cycles the dispatch holds or which block ran it: the first cycles of a long
    dispatch equal a short dispatch of those cycles alone."""
    xr, xi = _planes(cycles, seed=cycles + averaging, a=averaging)
    got = fused_band_features((xr, xi), averaging=averaging)
    again = fused_band_features((xr, xi), averaging=averaging)
    head = max(1, cycles // 3)
    alone = fused_band_features((xr[: head * averaging], xi[: head * averaging]),
                                averaging=averaging)
    want = fused_band_features_plain((xr, xi), averaging=averaging)
    torch.cuda.synchronize()
    assert got.shape == (cycles, 4)
    assert torch.equal(got, again) and torch.equal(got[:head], alone)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0.0)


def test_dense_sense_kernel_takes_interleaved_planes_and_rejects_bad_input():
    xr, xi = _planes(6, seed=9)
    planes = torch.stack([xr, xi], dim=-1).reshape(6, 10, 512, 2)
    got = fused_band_features(planes)
    assert torch.equal(got, fused_band_features((xr, xi)))
    assert fused_band_features(planes[:0]).shape == (0, 4)
    with pytest.raises(TypeError, match="float32"):
        fused_band_features(planes.double())
    with pytest.raises(ValueError, match="N=512"):
        fused_band_features((xr.reshape(-1, 256), xi.reshape(-1, 256)))
    with pytest.raises(ValueError, match="but xi on cpu"):
        fused_band_features((xr, xi.cpu()))
    with pytest.raises(ValueError, match="not divisible"):
        fused_band_features((xr[:15], xi[:15]))
    # scalar loads: planes at any float's alignment pass as they are
    flat_r, flat_i = xr.reshape(-1), xi.reshape(-1)
    odd = (flat_r[1 : 1 + 20 * 512].reshape(20, 512), flat_i[1 : 1 + 20 * 512].reshape(20, 512))
    assert odd[0].data_ptr() % 16 != 0
    want = fused_band_features_plain(odd)
    torch.testing.assert_close(fused_band_features(odd), want, rtol=1e-4, atol=0.0)


def _candidates(k, seed, n=2_500_000, prefix=304):
    rng = np.random.default_rng(seed)
    offs = np.sort(rng.integers(0, n + 2000, k))
    if k > 2:
        offs[1] = offs[0]
    cols = (offs, rng.uniform(0, 1, k).astype(np.float32), rng.uniform(0, 1, k) < 0.9,
            rng.integers(prefix, 6000, k), np.array([int(rng.integers(0, n))]))
    return tuple(torch.from_numpy(c).cuda() for c in cols), n, prefix


@pytest.mark.parametrize("k", [1, 2, 16, 255, 256, 257, 520, 1500])
def test_resolve_kernel_equals_plain(k):
    for seed in range(4):
        cols, n, prefix = _candidates(k, seed)
        before = resolve_candidates.launches
        accept, meta = resolve_candidates(*cols, 0.2, n, prefix)
        assert resolve_candidates.launches == before + 1
        want_accept, want_meta = resolve_candidates_plain(*cols, 0.2, n, prefix)
        assert accept.dtype == torch.bool and meta.dtype == torch.int64
        assert torch.equal(accept, want_accept) and torch.equal(meta, want_meta)
    # spaced like real frames, so that most are accepted and the walk ends at an overrun
    offs = torch.arange(k, device="cuda") * 5376 + 100
    flen = torch.full((k,), 4864, device="cuda")
    cols = (offs, torch.ones(k, device="cuda"), torch.ones(k, dtype=torch.bool, device="cuda"),
            flen, torch.tensor([k * 5376 - 304], device="cuda"))
    n = (k - 1) * 5376 + 100 + 4000
    got = resolve_candidates(*cols, 0.2, n, 304)
    want = resolve_candidates_plain(*cols, 0.2, n, 304)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[0].sum()) == k - 1 and got[1].tolist() == [
        (k - 2) * 5376 + 100 + 4864 if k > 1 else 0, (k - 1) * 5376 + 100, 1]


def test_resolve_kernel_rejects_bad_input():
    (offs, peaks, ok, flen, keep0), n, prefix = _candidates(8, 0)
    with pytest.raises(TypeError, match="int64 offs"):
        resolve_candidates(offs.int(), peaks, ok, flen, keep0, 0.2, n, prefix)
    with pytest.raises(TypeError, match="bool ok"):
        resolve_candidates(offs, peaks, ok.int(), flen, keep0, 0.2, n, prefix)
    with pytest.raises(ValueError, match="four"):
        resolve_candidates(offs, peaks[:4], ok, flen, keep0, 0.2, n, prefix)
    with pytest.raises(ValueError, match="one card"):
        resolve_candidates(offs, peaks, ok, flen.cpu(), keep0, 0.2, n, prefix)
    with pytest.raises(ValueError, match="contiguous"):
        resolve_candidates(offs, peaks, ok, flen.repeat(2)[::2], keep0, 0.2, n, prefix)


def test_stream_receiver_on_card_three_apis_and_cpu_agree():
    """A mixed-config stream through ``StreamReceiver(cfg)`` on the card: the
    three APIs agree with each other and with the CPU run of the plain paths,
    the step launches both kernels, and ``feed_device`` waits for nothing."""
    rng = np.random.default_rng(7)
    cfg_a = OFDMFrameConfig()
    cfg_b = OFDMFrameConfig(mod_scheme="qam16", fec0="none")
    f = 6
    n = 30000
    data = (0.003 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    sent, pos = [], 60
    for i in range(2 * f):
        cfg, plen = ((cfg_a, 64), (cfg_b, 48))[i % 2]
        h = rng.integers(0, 256, (1, 8)).astype(np.uint8)
        p = rng.integers(0, 256, (1, plen)).astype(np.uint8)
        iq = OFDMFrameGen(cfg, plen).assemble(h, p, device="cpu")[0].numpy()
        if pos + len(iq) + 50 >= n:
            break
        data[pos : pos + len(iq)] += iq
        sent.append((pos, p[0]))
        pos += len(iq) + 911
    rx_h, rx_d, rx_p = (StreamReceiver(cfg_a, max_frames_per_block=8) for _ in range(3))
    rx_c = StreamReceiver(cfg_a, max_frames_per_block=8, device="cpu")
    assert rx_h.device.type == "cuda"
    out = {"host": [], "dev": [], "pipe": [], "cpu": []}
    before = (extract_windows.launches, resolve_candidates.launches)
    steps = 0
    for s in range(0, n, 2048):
        seg = data[s : s + 2048]
        re, im = torch.from_numpy(seg.real.copy()).cuda(), torch.from_numpy(seg.imag.copy()).cuda()
        out["host"] += rx_h.process(seg)
        out["dev"] += rx_d.process_device(re, im)
        torch.cuda.set_sync_debug_mode("error")  # a wait inside the dispatch would raise
        before_feed = extract_windows.launches
        try:
            got = rx_p.feed_device(re, im, max_lag=100)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert got == []
        # the refinement windows, then the header and frame windows in one launch
        assert extract_windows.launches == before_feed + 2
        out["cpu"] += rx_c.process_device(re.cpu(), im.cpu())
        steps += 1
    out["pipe"] += rx_p.flush()
    assert resolve_candidates.launches == before[1] + 2 * steps
    assert extract_windows.launches >= before[0] + (2 + 2 + 2) * steps  # each API's scan: 2
    assert len(out["host"]) == len(sent) >= 8
    for key, frames in out.items():
        assert [fr["offset"] for fr in frames] == [fr["offset"] for fr in out["host"]], key
        for fr, (off, pay) in zip(frames, sent):
            assert abs(fr["offset"] - off) <= 2 and fr["stats"].payload_valid
            assert (fr["payload"] == pay).all()


def test_stream_receiver_refuses_planes_on_another_device():
    """A receiver made for the CPU refuses planes on the card, and a receiver
    made for the card takes host planes by moving them there."""
    cfg = OFDMFrameConfig()
    on_card = torch.zeros(4000, device="cuda")
    with pytest.raises(ValueError, match="receiver on cpu was given planes on cuda:0"):
        StreamReceiver(cfg, device="cpu").feed_device(on_card, on_card)
    rx = StreamReceiver(cfg)
    assert rx.process_device(torch.zeros(4000), on_card) == []
    assert rx._res_r_d.device.type == "cuda"
    if torch.cuda.device_count() == 1:
        with pytest.raises(ValueError, match="receiver on cuda:1 was given planes on cuda:0"):
            StreamReceiver(cfg, device="cuda:1").feed_device(on_card, on_card)


def _link_cfg(run_time):
    """The two-node FDD link of tests/test_runtime.py:117-145."""
    from cognitive_radio_network_tpu_torch.runtime import NodeConfig, ScenarioConfig

    common = dict(tx_rate=1e6, rx_rate=1e6, tx_gain=20.0, rx_gain=20.0, tx_gain_soft=-6.0,
                  ce_timeout_ms=1000.0, net_mean_throughput=200e3)
    return ScenarioConfig(
        num_nodes=2, run_time=run_time, medium_rate=4e6, medium_center=465e6,
        medium_block_len=16384, medium_noise_power=1e-7, name="two_node_link",
        nodes=[NodeConfig(tx_freq=464e6, rx_freq=466e6, **common),
               NodeConfig(tx_freq=466e6, rx_freq=464e6, **common)],
    )


def test_distributed_link_on_card_equals_in_process():
    """Two node processes on the card (TCP ports 47750-47751): the summary of
    the in-process run on the card, and each node launched the extract kernel."""
    import dataclasses

    from cognitive_radio_network_tpu_torch.runtime import ScenarioRuntime
    from cognitive_radio_network_tpu_torch.runtime.netctl import NetController

    want = ScenarioRuntime(_link_cfg(0.1)).run()
    for port, transport in ((47750, "native"), (47751, "python")):
        ctl = NetController(_link_cfg(0.1), port=port, transport=transport, start_pad_s=0.5)
        assert ctl.device.type == "cuda"
        got = ctl.run()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert sum(got.valid_frames) > 0
        assert all(ctl.summaries[i]["launches"]["extract_windows"] > 0 for i in (0, 1))


_CARD_RADIO = '''
from cognitive_radio_network_tpu_torch.runtime.config import NodeConfig
from cognitive_radio_network_tpu_torch.runtime.control import build_node
from cognitive_radio_network_tpu_torch.runtime.medium import MediumConfig

def create_node(node_id, medium_rate, medium_center, config, device):
    assert device.type == "cuda"
    nc = NodeConfig(**vars(config))
    nc.cognitive_radio_type = "ecr"
    mcfg = MediumConfig(sample_rate_hz=medium_rate, center_hz=medium_center)
    return build_node(node_id, nc, mcfg, None, device=device)
'''


def test_process_radio_on_card_carries_the_link(tmp_path):
    """A ``python-process`` radio that builds a port node runs its child on
    the card (``--device cuda``) and carries frames to its in-process peer."""
    from cognitive_radio_network_tpu_torch.runtime import ScenarioRuntime

    f = tmp_path / "card_radio.py"
    f.write_text(_CARD_RADIO)
    cfg = _link_cfg(0.25)
    cfg.nodes[1].cognitive_radio_type = "python-process"
    cfg.nodes[1].python_file = str(f)
    rt = ScenarioRuntime(cfg)
    rt.run()
    assert not rt.failed_nodes, rt.failed_nodes
    argv = rt.nodes[1]._proc.args
    assert argv[argv.index("--device") + 1].startswith("cuda")
    assert len(rt.nodes[0].rx_packets) > 0 and rt.nodes[0].radio.device.type == "cuda"


def test_make_dataset_on_card_launches_sense_kernel_once_and_matches_cpu(monkeypatch):
    """make_dataset's features come from one fused_sense_ct launch, equal to the
    plain path's on the CPU on the same scene (kernel vs plain: rtol 1e-4)."""
    from cognitive_radio_network_tpu_torch.models import sense_classify
    from cognitive_radio_network_tpu_torch.models import train as ttrain

    seen = {}
    synth = ttrain.synthesize_scene

    def capture(*args, **kw):
        seen["planes"] = synth(*args, **kw)
        return seen["planes"]

    monkeypatch.setattr(ttrain, "synthesize_scene", capture)
    before = fused_sense_ct.launches
    feats, labels = ttrain.make_dataset(torch.Generator(device="cuda").manual_seed(0), 400)
    torch.cuda.synchronize()
    assert fused_sense_ct.launches == before + 1
    assert feats.device.type == "cuda" and feats.shape == (400, 4) and labels.shape == (400, 3)
    planes = seen["planes"].cpu()
    want = sense_classify((planes[..., 0], planes[..., 1]), reference_weights())["features"]
    torch.testing.assert_close(feats.cpu(), want, rtol=1e-4, atol=0.0)


def test_wideband_train_step_on_card_launches_kernel_per_stream_and_matches_packed():
    """One step over a batch of B streams launches the wideband kernel once;
    its loss equals the loss over the packed plain path's energies (rtol 1e-5)."""
    from cognitive_radio_network_tpu_torch.models.distributed import (
        _loss,
        make_sharded_train_step,
        wideband_features,
    )
    from cognitive_radio_network_tpu_torch.parallel.wideband import wideband_sense

    cfg = WidebandConfig()
    g = torch.Generator(device="cuda").manual_seed(5)
    b, t = 3, 1024
    planes = 1e-3 * torch.randn(b, t * 64, 2, generator=g, device="cuda")
    labels = torch.zeros(b, t // cfg.block_len, 64, device="cuda")
    n = torch.arange(t * 64, device="cuda", dtype=torch.float64)
    for i, k in enumerate((5, 20, 41)):
        ph = 2 * torch.pi * ((k * n) % 64) / 64
        planes[i] += torch.stack([ph.cos(), ph.sin()], dim=-1).float()
        labels[i, :, k] = 1.0
    init_fn, step_fn = make_sharded_train_step(cfg, learning_rate=3e-2)
    state = init_fn(torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():
        res = wideband_sense(planes, torch.from_numpy(cfg.taps()).cuda(), cfg, use_fused=False)
        want = _loss(state.params, wideband_features(res["energy"], res["noise"]), labels)
    before = wideband_energy_fused.launches
    state, loss = step_fn(state, planes, labels)
    torch.cuda.synchronize()
    assert wideband_energy_fused.launches == before + 1
    assert state.step == 1 and loss.device.type == "cuda"
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=0.0)
