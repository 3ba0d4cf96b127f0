"""The CUDA kernels of the port against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one (the condition is a string,
evaluated when each test runs, so every worker collects the same tests).
Run them on a GPU machine with (``--noconftest``: tests/conftest.py imports
JAX, which a machine for the port need not have):

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -q

Bounds are those of chip_smoke.py: avg rtol 1e-4, atol 1e-5 and feats rtol
1e-4 for f32 input; feats rtol 2e-2 of the f32 result for bf16 input.
``extract_windows`` is a copy: its kernel must equal the plain version bit
for bit (``torch.equal``).
"""

import pytest
import torch

from cognitive_radio_network_tpu_torch.models import SenseConfig, make_sense_fn
from cognitive_radio_network_tpu_torch.ops.extract import extract_windows, extract_windows_plain
from cognitive_radio_network_tpu_torch.ops.fused_sense_ct import (
    fused_sense_ct,
    fused_sense_ct_plain,
)
from cognitive_radio_network_tpu_torch.phy import OFDMFrameConfig, OFDMFrameGen, OFDMFrameSync
from cognitive_radio_network_tpu_torch.signal.mlp import reference_weights

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
    cpu = fn((xr.cpu(), xi.cpu()), reference_weights())
    assert torch.equal(res["decision"].cpu(), cpu["decision"])
    torch.testing.assert_close(res["features"].cpu(), cpu["features"], rtol=1e-4, atol=0.0)


LINK_N = 1_265_664  # 256 default-config frames of 4864 samples with 80-sample gaps


def _link_planes(n, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(n, generator=g, device="cuda") for _ in range(2))


@pytest.mark.parametrize(
    "n,k,wlen",
    [(LINK_N, 256, 4864), (LINK_N, 256, 160), (LINK_N, 3, 333), (100, 4, 160), (5000, 1, 1)],
)
def test_extract_kernel_equals_plain(n, k, wlen):
    rr, ri = _link_planes(n, seed=k)
    g = torch.Generator(device="cuda").manual_seed(wlen)
    offs = torch.randint(-50, n + 50, (k,), generator=g, device="cuda")
    edge = torch.tensor([-7, n - 3, n + 100, 0, 1, n - wlen], device="cuda")
    offs[: min(k, 6)] = edge[: min(k, 6)]
    for o in (offs, offs.int()):
        before = extract_windows.launches
        got = extract_windows(rr, ri, o, wlen)
        assert extract_windows.launches == before + 1
        want = extract_windows_plain(rr, ri, o, wlen)
        torch.cuda.synchronize()
        assert got[0].shape == (k, wlen)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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
