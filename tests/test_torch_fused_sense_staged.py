"""The passes of the CUDA sense kernels, emulated on the CPU.

Both kernels (csrc/fused_sense_ct.cu: spectrum and features; csrc/fused_sense.cu:
features only) run the register FFT and the walk over cycles of
csrc/fft512_warp.cuh.  They cannot run without a card, so what surrounds their
arithmetic is held here: the twiddle table the wrappers hand them
(``ops/_sense.py``), the W_32 table in the shared header (parsed from the source),
the 16 x 32 index maps, the class sums over a cycle's rows, and the shared
epilogue.  The emulation walks the same passes in float32 with those tables:

    lane n2 holds x[32 n1 + n2] -> 4 x 4 FFT over n1 -> * W_512^(n2 k1)
    -> lane (k1, p): v[b] = z[k1][b] + (-1)^p z[k1][b + 16], * W_32^(b p)
    -> 4 x 4 FFT over b -> bin k1 + 16 p + 32 k2'

and is held to ``torch.fft.fft`` in float64 (atol 1e-4 on unit-variance input:
float32 rounding of a 512-point transform is about 1e-5), to
``fused_sense_ct_plain`` (avg rtol 1e-4, atol 1e-5; feats rtol 1e-4: the
bounds the kernel is held to on the card) and to the JAX Pallas kernel in
interpret mode (features rtol 5e-3, the golden gate's bound).  The
features-only path is the same emulation without its spectrum, held to
``fused_band_features_plain`` (the dense four-matmul form, rtol 1e-4) and to
the JAX dense-DFT kernel in interpret mode (rtol 1e-4).
"""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import cognitive_radio_network_tpu_torch
import cognitive_radio_network_tpu.ops.fused_sense as jax_fsops
from cognitive_radio_network_tpu.ops.fused_sense_ct import fused_sense_ct as jax_fused_sense_ct
from cognitive_radio_network_tpu_torch.ops.fused_sense import fused_band_features_plain
from cognitive_radio_network_tpu_torch.ops._sense import twiddles as _twiddles
from cognitive_radio_network_tpu_torch.ops.fused_sense_ct import fused_sense_ct_plain
from cognitive_radio_network_tpu_torch.signal.bands import band_matrix

CSRC = Path(cognitive_radio_network_tpu_torch.__file__).parent / "csrc"
SOURCE = CSRC / "fft512_warp.cuh"  # the row transform both kernels include
WARPS = 4  # row classes of a cycle: rows a, a + 4, a + 8, ... are summed together


def source_w32() -> torch.Tensor:
    """The (32, 2) W_32 table as the kernels' shared header spells it."""
    text = SOURCE.read_text()
    body = text[text.index("kW32[32][2] = {") :]
    body = body[: body.index("};")]
    pairs = re.findall(r"\{\s*(-?[0-9.]+)f,\s*(-?[0-9.]+)f\s*\}", body)
    assert len(pairs) == 32
    return torch.tensor([[float(c), float(s)] for c, s in pairs], dtype=torch.float32)


def cmul(r, i, c, s):
    return r * c - i * s, r * s + i * c


def dft4(r, i):
    """The kernel's dft4 on lists of four tensors; outputs in natural order."""
    s0r, s0i = r[0] + r[2], i[0] + i[2]
    s1r, s1i = r[0] - r[2], i[0] - i[2]
    s2r, s2i = r[1] + r[3], i[1] + i[3]
    s3r, s3i = r[1] - r[3], i[1] - i[3]
    return (
        [s0r + s2r, s1r + s3i, s0r - s2r, s1r - s3i],
        [s0i + s2i, s1i - s3r, s0i - s2i, s1i + s3r],
    )


def fft16(re, im, w32):
    """The kernel's fft16: lists of 16 tensors in natural order, in and out."""
    re, im = list(re), list(im)
    for n2 in range(4):
        idx = [n2, n2 + 4, n2 + 8, n2 + 12]
        r, i = dft4([re[j] for j in idx], [im[j] for j in idx])
        for k1, j in enumerate(idx):
            re[j], im[j] = r[k1], i[k1]
    for n2 in range(1, 4):
        for k1 in range(1, 4):
            j = n2 + 4 * k1
            re[j], im[j] = cmul(re[j], im[j], w32[2 * n2 * k1, 0], w32[2 * n2 * k1, 1])
    out_r, out_i = [None] * 16, [None] * 16
    for k1 in range(4):
        idx = [4 * k1 + n2 for n2 in range(4)]
        r, i = dft4([re[j] for j in idx], [im[j] for j in idx])
        for k2 in range(4):
            out_r[k1 + 4 * k2], out_i[k1 + 4 * k2] = r[k2], i[k2]
    return out_r, out_i


def staged_fft512(xr, xi, tw, w32):
    """(R, 512) float32 rows -> (R, 512) spectrum planes, by the kernel's passes."""
    rows = xr.shape[0]
    lane = torch.arange(32)
    # pass 1: lane n2 holds x[32 n1 + n2]
    re = [xr[:, 32 * n1 : 32 * n1 + 32] for n1 in range(16)]
    im = [xi[:, 32 * n1 : 32 * n1 + 32] for n1 in range(16)]
    re, im = fft16(re, im, w32)
    for k1 in range(1, 16):
        re[k1], im[k1] = cmul(re[k1], im[k1], tw[0, lane * k1], tw[1, lane * k1])
    tile_r, tile_i = torch.stack(re, dim=1), torch.stack(im, dim=1)  # (R, k1, n2)
    # pass 2: lane L = k1 + 16 p reads row k1 of the tile
    k1 = lane % 16
    sign = torch.where(lane >= 16, -1.0, 1.0)
    odd = lane >= 16
    vr, vi = [], []
    for b in range(16):
        r = tile_r[:, k1, b] + sign * tile_r[:, k1, b + 16]  # (R, 32 lanes)
        i = tile_i[:, k1, b] + sign * tile_i[:, k1, b + 16]
        tr, ti = cmul(r, i, w32[b, 0], w32[b, 1])
        vr.append(torch.where(odd, tr, r))
        vi.append(torch.where(odd, ti, i))
    vr, vi = fft16(vr, vi, w32)
    out_r = torch.empty((rows, 512))
    out_i = torch.empty((rows, 512))
    for k in range(16):  # lane L's output k is bin L + 32 k
        out_r[:, 32 * k : 32 * k + 32] = vr[k]
        out_i[:, 32 * k : 32 * k + 32] = vi[k]
    return out_r, out_i


def staged_sense(xr, xi, averaging):
    """The whole kernel: (avg (C, 512), feats (C, 4)) from (C*A, 512) planes."""
    tw = _twiddles(torch.device("cpu"))
    fr, fi = staged_fft512(xr.float(), xi.float(), tw, source_w32())
    mag = torch.sqrt(fr * fr + fi * fi).reshape(-1, averaging, 512)
    classes = []
    for r in range(WARPS):  # a class adds its rows in order; an empty class is 0
        acc = torch.zeros((mag.shape[0], 512))
        for a in range(r, averaging, WARPS):
            acc = acc + mag[:, a]
        classes.append(acc)
    total = ((classes[0] + classes[1]) + classes[2]) + classes[3]
    avg = total / float(averaging)
    sums = avg @ band_matrix()
    return avg, sums * sums


def planes(rng, cycles, averaging):
    iq = rng.standard_normal((cycles, averaging, 512, 2)).astype(np.float32)
    xr = np.ascontiguousarray(iq[..., 0]).reshape(-1, 512)
    xi = np.ascontiguousarray(iq[..., 1]).reshape(-1, 512)
    return iq, torch.from_numpy(xr), torch.from_numpy(xi)


def test_tables_are_float32_roundings_of_float64():
    k = np.arange(512)
    tw = _twiddles(torch.device("cpu"))
    assert tw.shape == (2, 512) and tw.dtype == torch.float32
    np.testing.assert_array_equal(tw[0].numpy(), np.cos(-2 * np.pi * k / 512).astype(np.float32))
    np.testing.assert_array_equal(tw[1].numpy(), np.sin(-2 * np.pi * k / 512).astype(np.float32))
    e = np.arange(32)
    want = np.stack([np.cos(-2 * np.pi * e / 32), np.sin(-2 * np.pi * e / 32)], axis=1)
    want[np.abs(want) < 1e-9] = 0.0  # the source writes the axis points exactly
    np.testing.assert_array_equal(source_w32().numpy(), want.astype(np.float32))
    # the lane's largest exponent, 31 * 15, lies inside the table
    assert 31 * 15 < tw.shape[1]


def test_fft16_emulation_is_a_16_point_dft(rng):
    x = rng.standard_normal((16, 7)) + 1j * rng.standard_normal((16, 7))
    re = [torch.from_numpy(x[n].real.astype(np.float32)) for n in range(16)]
    im = [torch.from_numpy(x[n].imag.astype(np.float32)) for n in range(16)]
    out_r, out_i = fft16(re, im, source_w32())
    got = torch.stack(out_r).numpy() + 1j * torch.stack(out_i).numpy()
    np.testing.assert_allclose(got, np.fft.fft(x, axis=0), atol=2e-5)


@pytest.mark.parametrize("rows", [1, 6])
def test_staged_fft_matches_float64_fft(rng, rows):
    xr = torch.from_numpy(rng.standard_normal((rows, 512)).astype(np.float32))
    xi = torch.from_numpy(rng.standard_normal((rows, 512)).astype(np.float32))
    fr, fi = staged_fft512(xr, xi, _twiddles(torch.device("cpu")), source_w32())
    want = torch.fft.fft(torch.complex(xr.double(), xi.double()), dim=-1)
    torch.testing.assert_close(fr.double(), want.real, rtol=0, atol=1e-4)
    torch.testing.assert_close(fi.double(), want.imag, rtol=0, atol=1e-4)


@pytest.mark.parametrize("averaging", [1, 3, 10])
@pytest.mark.parametrize("cycles", [1, 5])
def test_staged_kernel_matches_plain(rng, cycles, averaging):
    _, xr, xi = planes(rng, cycles, averaging)
    avg, feats = staged_sense(xr, xi, averaging)
    want_avg, want_feats = fused_sense_ct_plain(xr, xi, averaging=averaging, precision="highest")
    assert avg.shape == (cycles, 512) and feats.shape == (cycles, 4)
    torch.testing.assert_close(avg, want_avg, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(feats, want_feats, rtol=1e-4, atol=0.0)


@pytest.mark.parametrize("averaging", [1, 3, 10])
@pytest.mark.parametrize("cycles", [1, 5])
def test_staged_kernel_matches_jax_kernel(rng, cycles, averaging):
    iq, xr, xi = planes(rng, cycles, averaging)
    want_avg, want_feats = jax_fused_sense_ct(jnp.asarray(iq), tile_c=4, interpret=True)
    avg, feats = staged_sense(xr, xi, averaging)
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_feats), rtol=5e-3)
    np.testing.assert_allclose(avg.numpy(), np.asarray(want_avg), rtol=1e-3, atol=1e-4)


def test_staged_kernel_bf16_input(rng):
    """bf16 planes are upcast exactly, then take the float32 passes."""
    _, xr, xi = planes(rng, 4, 10)
    _, want = fused_sense_ct_plain(xr, xi, averaging=10, precision="highest")
    _, got = staged_sense(xr.bfloat16(), xi.bfloat16(), 10)
    torch.testing.assert_close(got, want, rtol=2e-2, atol=0.0)


@pytest.mark.parametrize("name", ["fused_sense_ct.cu", "fused_sense.cu"])
def test_both_kernels_run_the_shared_row_transform(name):
    """Each kernel file includes the shared header and calls its walk; neither
    keeps a transform of its own, and the features-only kernel holds no
    matrix product, no DFT matrices and writes no spectrum."""
    text = (CSRC / name).read_text()
    code = "\n".join(line.split("//")[0] for line in text.splitlines())
    assert '#include "fft512_warp.cuh"' in code
    assert "crn::sense_cycles<" in code and "crn::sense_grid(" in code
    for own in ("fft16", "kW32", "dft4", "fmaf", "Smem"):
        assert own not in code, own
    if name == "fused_sense.cu":
        assert "crn::sense_cycles<float, false>" in code
        assert "fre" not in code and "fim" not in code and "avg" not in code
        assert len(text.splitlines()) < 249 // 2  # it was 249 lines as a tiled product
    header = SOURCE.read_text()
    assert "kWriteAvg ? avg + cycle * kSenseN : nullptr" in header


@pytest.mark.parametrize("averaging", [1, 3, 10])
@pytest.mark.parametrize("cycles", [1, 5])
def test_staged_features_only_matches_dense_plain(rng, cycles, averaging):
    """The features-only kernel's passes against the plain version it is held
    to on the card: the dense four-matmul form."""
    _, xr, xi = planes(rng, cycles, averaging)
    _, feats = staged_sense(xr, xi, averaging)
    want = fused_band_features_plain((xr, xi), averaging=averaging)
    assert feats.shape == want.shape == (cycles, 4)
    torch.testing.assert_close(feats, want, rtol=1e-4, atol=0.0)


@pytest.mark.parametrize("cycles,averaging", [(4, 10), (8, 3)])
def test_staged_features_only_matches_jax_dense_kernel(rng, monkeypatch, cycles, averaging):
    """Against the TPU kernel this one replaces, in interpret mode (the
    ``pallas_call`` patch of tests/test_ops_pallas.py:15-22)."""
    orig = jax_fsops.pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        kw.pop("cost_estimate", None)
        return orig(*args, **kw)

    monkeypatch.setattr(jax_fsops.pl, "pallas_call", interp_call)
    iq, xr, xi = planes(rng, cycles, averaging)
    want = jax_fsops.fused_band_features(jnp.asarray(iq), tile_c=4)
    _, feats = staged_sense(xr, xi, averaging)
    np.testing.assert_allclose(feats.numpy(), np.asarray(want), rtol=1e-4)
