"""Port parity: ``extract_windows_plain`` vs the JAX package's ``extract_windows``.

On the CPU the JAX wrapper runs its dynamic-slice fallback, as
tests/test_ops_pallas.py:138-165 runs it.  Both sides get the same numpy
planes and offsets; the rows must be bit-equal (a gather is a copy).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cognitive_radio_network_tpu.ops.extract import extract_windows as jax_extract_windows
from cognitive_radio_network_tpu_torch.ops.extract import extract_windows, extract_windows_plain


def _case(rng, n, wlen, offs):
    rr = rng.standard_normal(n).astype(np.float32)
    ri = rng.standard_normal(n).astype(np.float32)
    return rr, ri, np.asarray(offs, np.int32), wlen


# (n, wlen, offsets): in-range rows, clipped offsets (-7, N-3, N+100), N < wlen,
# a frame-sized window, an odd width at unaligned offsets
_CASES = {
    "rows": (50000, 470, "random"),
    "clipped": (4096, 512, [-7, 4096 - 3, 4096 + 100, 0]),
    "n-lt-wlen": (100, 160, [0, 5, -3, 200]),
    "frame": (20000, 4864, [0, 1, 777, 20000 - 4864, 19999]),
    "odd-unaligned": (9001, 333, [3, 5, 1027, 8667, 8668, -1]),
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_plain_matches_jax(rng, name):
    n, wlen, offs = _CASES[name]
    if offs == "random":
        offs = rng.integers(0, n - wlen, 13)
    rr, ri, offs, wlen = _case(rng, n, wlen, offs)
    want_r, want_i = jax_extract_windows(jnp.asarray(rr), jnp.asarray(ri), jnp.asarray(offs), wlen)
    got_r, got_i = extract_windows_plain(
        torch.from_numpy(rr), torch.from_numpy(ri), torch.from_numpy(offs), wlen
    )
    assert got_r.shape == got_i.shape == (len(offs), wlen)
    assert got_r.dtype == got_i.dtype == torch.float32
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    # and the contract itself: plane[clip(o) : clip(o) + wlen], zero past N
    pad_r = np.concatenate([rr, np.zeros(max(wlen - n, 0), np.float32)])
    for k, o in enumerate(offs):
        oc = min(max(int(o), 0), max(n - wlen, 0))
        np.testing.assert_array_equal(got_r[k].numpy(), pad_r[oc : oc + wlen])


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_wrapper_on_cpu_runs_plain_version(rng, dtype):
    """A CPU tensor takes the plain version, bit for bit, whatever the
    offsets' integer type, and launches nothing."""
    rr, ri, offs, wlen = _case(rng, 3000, 160, [0, 2999, -5, 1234])
    args = (torch.from_numpy(rr), torch.from_numpy(ri), torch.from_numpy(offs).to(dtype), wlen)
    before = extract_windows.launches
    got = extract_windows(*args)
    want = extract_windows_plain(*args)
    assert extract_windows.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
