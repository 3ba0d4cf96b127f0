"""The CUDA kernels of the port against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one (the condition is a string,
evaluated when each test runs, so every worker collects the same tests).
Run them on a GPU machine with (``--noconftest``: tests/conftest.py imports
JAX, which a machine for the port need not have):

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -q

Bounds are those of chip_smoke.py: avg rtol 1e-4, atol 1e-5 and feats rtol
1e-4 for f32 input; feats rtol 2e-2 of the f32 result for bf16 input.
"""

import pytest
import torch

from cognitive_radio_network_tpu_torch.models import SenseConfig, make_sense_fn
from cognitive_radio_network_tpu_torch.ops.fused_sense_ct import (
    fused_sense_ct,
    fused_sense_ct_plain,
)
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
