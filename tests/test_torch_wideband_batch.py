"""Port parity: the wideband kernel's batch and interleaved-planes forms (their
plain versions on the CPU) against the JAX package's kernel, and the
equalities the kernel keeps on the card.

The JAX Pallas kernel runs in interpret mode with ``tile_q`` 256 or 512, so T
comes from {512, 1024, 4096}; it takes one stream, so it runs stream by
stream, each stream with its own ``initial_history``.  Tolerances are those of
tests/test_torch_wideband.py: rtol 1e-5, atol 1e-7 at "highest" (both sides
float32, different summation orders).  Between the port's own forms the
results are compared with ``torch.equal``: a batch and its streams one by
one, interleaved planes, planar streams and complex64 input all take the
same arithmetic.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cognitive_radio_network_tpu.ops.fused_wideband import (
    wideband_energy_fused as jax_wideband_energy_fused,
)
from cognitive_radio_network_tpu.parallel import wideband as jwb
from cognitive_radio_network_tpu_torch.ops.fused_wideband import (
    in_place_or_copy,
    wideband_energy_fused,
    wideband_energy_fused_plain,
    wideband_energy_fused_planes,
    wideband_energy_fused_planes_plain,
)
from cognitive_radio_network_tpu_torch.parallel.wideband import (
    WidebandConfig,
    make_wideband_fn,
    wideband_sense,
)

CFG = WidebandConfig()
JCFG = jwb.WidebandConfig()
TAPS = CFG.taps()


def _batch(rng, b, t):
    """(B, T*64, 2) float32 planes and (B, 4, 128) histories per plane."""
    planes = rng.standard_normal((b, t * 64, 2)).astype(np.float32)
    hist = tuple(rng.standard_normal((b, 4, 128)).astype(np.float32) for _ in range(2))
    return planes, hist


def _forms(planes: np.ndarray):
    """The same samples as interleaved planes, a planar tuple and complex64."""
    p = torch.from_numpy(planes)
    return {
        "planes": p,
        "planar": (p[..., 0].contiguous(), p[..., 1].contiguous()),
        "complex": torch.view_as_complex(p.clone()),
    }


def _fused(form, x, **kw):
    if form == "planar":
        return wideband_energy_fused(*x, TAPS, CFG, **kw)
    return wideband_energy_fused_planes(x, TAPS, CFG, **kw)


@pytest.mark.parametrize("form", ["planes", "planar", "complex"])
@pytest.mark.parametrize("t,tile_q", [(512, 256), (1024, 512), (4096, 512)])
def test_batch_matches_jax_kernel_stream_by_stream(rng, t, tile_q, form):
    """Each stream of a batch, with its own history, against the JAX kernel
    on that stream alone."""
    b = 2
    planes, hist = _batch(rng, b, t)
    got = _fused(form, _forms(planes)[form], precision="highest",
                 initial_history=tuple(torch.from_numpy(h) for h in hist))
    assert got.shape == (b, t // 128, 64) and got.dtype == torch.float32
    for i in range(b):
        want = jax_wideband_energy_fused(
            jnp.asarray(planes[i, :, 0]), jnp.asarray(planes[i, :, 1]), jnp.asarray(TAPS), JCFG,
            precision="highest", tile_q=tile_q, interpret=True,
            initial_history=(jnp.asarray(hist[0][i]), jnp.asarray(hist[1][i])),
        )
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("with_history", [False, True])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_forms_and_streams_one_by_one_are_equal(rng, precision, with_history):
    """Interleaved, planar and complex input give the same bits; so does a
    batch and its streams one by one (with their histories)."""
    b, t = 3, 512
    planes, hist = _batch(rng, b, t)
    hist = tuple(torch.from_numpy(h) for h in hist) if with_history else None
    forms = _forms(planes)
    got = {f: _fused(f, x, precision=precision, initial_history=hist) for f, x in forms.items()}
    assert torch.equal(got["planar"], got["planes"]) and torch.equal(got["complex"], got["planes"])
    xr, xi = forms["planar"]
    for i in range(b):
        h_i = None if hist is None else (hist[0][i], hist[1][i])
        one = wideband_energy_fused(xr[i], xi[i], TAPS, CFG, precision=precision, initial_history=h_i)
        assert torch.equal(got["planes"][i], one)
        assert torch.equal(
            wideband_energy_fused_planes(forms["planes"][i], TAPS, CFG, precision=precision,
                                         initial_history=h_i),
            one,
        )


def test_leading_dimensions_and_plain_versions(rng):
    """Two leading dimensions flatten to one batch; the wrappers on CPU
    tensors are their plain versions, bit for bit, and launch nothing."""
    planes, hist = _batch(rng, 4, 256)
    p = torch.from_numpy(planes).reshape(2, 2, 256 * 64, 2)
    h = tuple(torch.from_numpy(v).reshape(2, 2, 4, 128) for v in hist)
    before = wideband_energy_fused.launches
    got = wideband_energy_fused_planes(p, TAPS, CFG, initial_history=h)
    assert wideband_energy_fused.launches == before
    assert got.shape == (2, 2, 2, 64)
    assert torch.equal(got, wideband_energy_fused_planes_plain(p, TAPS, CFG, initial_history=h))
    flat = wideband_energy_fused(p[..., 0].reshape(4, -1), p[..., 1].reshape(4, -1), TAPS, CFG,
                                 initial_history=tuple(v.reshape(4, 4, 128) for v in h))
    assert torch.equal(got.reshape(4, 2, 64), flat)
    assert torch.equal(flat, wideband_energy_fused_plain(
        p[..., 0].reshape(4, -1), p[..., 1].reshape(4, -1), TAPS, CFG,
        initial_history=tuple(v.reshape(4, 4, 128) for v in h)))


def test_strided_streams_and_empty_batches(rng):
    """Evenly spaced streams (a stride of whole rows) are taken as they lie;
    an empty batch or empty streams give empty energies."""
    wide = torch.from_numpy(rng.standard_normal((3, 640 * 64, 2)).astype(np.float32))
    view = wide[:, : 512 * 64]
    assert in_place_or_copy(view, planes=True) is view
    assert torch.equal(wideband_energy_fused_planes(view, TAPS, CFG),
                       wideband_energy_fused_planes(view.contiguous(), TAPS, CFG))
    assert wideband_energy_fused_planes(view[:0], TAPS, CFG).shape == (0, 4, 64)
    assert wideband_energy_fused_planes(view[:, :0], TAPS, CFG).shape == (3, 0, 64)
    # a stream stride of half a row is copied by the callers, refused by the wrappers
    odd = torch.zeros(3, 512 * 64 + 32, 2)[:, : 512 * 64]
    copied = in_place_or_copy(odd, planes=True)
    assert copied is not odd and copied.is_contiguous() and torch.equal(copied, odd)


def test_wideband_sense_reads_every_layout_alike(rng):
    """``wideband_sense`` and ``make_wideband_fn`` give the same bits for a
    batch as planes, as a planar tuple and as complex input, and for each of
    its streams alone."""
    planes, _ = _batch(rng, 3, 256)
    forms = _forms(planes)
    got = {f: wideband_sense(x, TAPS, CFG) for f, x in forms.items()}
    for f in ("planar", "complex"):
        for key in ("energy", "noise", "occupied"):
            assert torch.equal(got[f][key], got["planes"][key]), (f, key)
    fn = make_wideband_fn(CFG, device="cpu")
    assert torch.equal(fn(planes)["energy"], got["planes"]["energy"])
    for i in range(3):
        assert torch.equal(fn(planes[i])["energy"], got["planes"]["energy"][i])
