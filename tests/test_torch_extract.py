"""Port parity: ``extract_windows_plain`` and ``extract_window_sets_plain`` vs
the JAX package's ``extract_windows``.

On the CPU the JAX wrapper runs its dynamic-slice fallback, as
tests/test_ops_pallas.py:138-165 runs it.  Both sides get the same numpy
planes and offsets; the rows must be bit-equal (a gather is a copy), each
window set against the JAX function at its own length.  The caller-owned
windows (``out=``) are checked here on the CPU, where the wrappers run the
plain versions, which check alike.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cognitive_radio_network_tpu.ops.extract import extract_windows as jax_extract_windows
from cognitive_radio_network_tpu_torch.ops.extract import (
    extract_window_sets,
    extract_window_sets_plain,
    extract_windows,
    extract_windows_plain,
    window_buffers,
)


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


@pytest.mark.parametrize("name", sorted(_CASES))
def test_int32_and_int64_offsets_give_equal_contiguous_rows(rng, name):
    """The offsets' integer type changes nothing, and each returned plane is
    a contiguous (K, wlen) tensor, whichever path made it."""
    n, wlen, offs = _CASES[name]
    if offs == "random":
        offs = rng.integers(0, n - wlen, 13)
    rr, ri, offs, wlen = _case(rng, n, wlen, offs)
    rr, ri, offs = torch.from_numpy(rr), torch.from_numpy(ri), torch.from_numpy(offs)
    for fn in (extract_windows, extract_windows_plain):
        a = fn(rr, ri, offs.to(torch.int32), wlen)
        b = fn(rr, ri, offs.to(torch.int64), wlen)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
            assert x.shape == (len(offs), wlen)
            assert x.is_contiguous() and y.is_contiguous()


# --- window sets at one offset vector, and caller-owned windows -------------

# (n, wlens, offsets): the stream step's three lengths with offsets near the
# end, where each set clips on its own (a prefix of the 4864 window at N-1000
# is not the 688 window there); a short set beside a long one at N < wlen;
# four sets with an empty one
_SET_CASES = {
    "step-near-end": (20000, (688, 4864, 2080), [0, 777, 20000 - 4864, 20000 - 1000, 19999, -4]),
    "n-lt-some": (3000, (160, 4864), [0, 2900, -1, 1234]),
    "four-sets": (9001, (333, 0, 160, 1024), [3, 5, 8667, 9000, -1]),
}


@pytest.mark.parametrize("name", sorted(_SET_CASES))
def test_window_sets_plain_matches_jax_per_set(rng, name):
    """Each set of ``extract_window_sets_plain`` is bit-equal to the JAX
    package's ``extract_windows`` at that set's length, clipped for that set
    alone."""
    n, wlens, offs = _SET_CASES[name]
    rr, ri, offs, _ = _case(rng, n, 0, offs)
    t_rr, t_ri, t_offs = torch.from_numpy(rr), torch.from_numpy(ri), torch.from_numpy(offs)
    sets = extract_window_sets_plain(t_rr, t_ri, t_offs, wlens)
    assert len(sets) == len(wlens)
    for (got_r, got_i), wlen in zip(sets, wlens):
        assert got_r.shape == got_i.shape == (len(offs), wlen)
        if wlen == 0:
            continue
        want_r, want_i = jax_extract_windows(jnp.asarray(rr), jnp.asarray(ri), jnp.asarray(offs), wlen)
        np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        one = extract_windows_plain(t_rr, t_ri, t_offs, wlen)
        assert torch.equal(one[0], got_r) and torch.equal(one[1], got_i)
    if name == "step-near-end":
        # per-set clipping: at N - 1000 the short window is not a prefix of the long one
        (short, _), (long_, _) = sets[0], sets[1]
        assert not torch.equal(short[3], long_[3, :688])
        assert torch.equal(short[1], long_[1, :688])  # in range: it is


def test_window_sets_share_one_allocation(rng):
    """Without ``out`` every set is a contiguous view of one allocation, each
    plane 256-byte aligned in it."""
    rr, ri, offs, _ = _case(rng, 5000, 0, [0, 17, 4999])
    sets = extract_window_sets_plain(torch.from_numpy(rr), torch.from_numpy(ri),
                                     torch.from_numpy(offs), (688, 4864, 2080))
    base = sets[0][0].untyped_storage().data_ptr()
    for wr, wi in sets:
        for x in (wr, wi):
            assert x.is_contiguous() and x.untyped_storage().data_ptr() == base
            assert (x.data_ptr() - base) % 256 == 0
    got = window_buffers(torch.zeros(1), 3, (688, 160))
    assert [tuple(x.shape) for pair in got for x in pair] == [(3, 688)] * 2 + [(3, 160)] * 2


@pytest.mark.parametrize("fn", ["extract_windows", "extract_windows_plain"])
def test_out_is_written_and_returned(rng, fn):
    """``out=``: the function writes the caller's tensors and returns them,
    equal to what it allocates itself."""
    fn = {"extract_windows": extract_windows, "extract_windows_plain": extract_windows_plain}[fn]
    rr, ri, offs, wlen = _case(rng, 6000, 688, [0, 5999, -2, 3000])
    args = (torch.from_numpy(rr), torch.from_numpy(ri), torch.from_numpy(offs), wlen)
    out = (torch.full((4, wlen), 7.0), torch.full((4, wlen), 7.0))
    got = fn(*args, out=out)
    assert got[0] is out[0] and got[1] is out[1]
    want = fn(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("fn", ["extract_window_sets", "extract_window_sets_plain"])
def test_sets_out_is_written_and_returned(rng, fn):
    fn = {"extract_window_sets": extract_window_sets,
          "extract_window_sets_plain": extract_window_sets_plain}[fn]
    rr, ri, offs, _ = _case(rng, 9000, 0, [0, 8999, 4000, -9])
    args = (torch.from_numpy(rr), torch.from_numpy(ri), torch.from_numpy(offs), (688, 4864))
    out = window_buffers(args[0], 4, (688, 4864))
    got = fn(*args, out=out)
    assert all(g[0] is o[0] and g[1] is o[1] for g, o in zip(got, out))
    for g, w in zip(got, fn(*args)):
        assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])


_BAD_OUT = {
    "shape": (lambda: torch.empty(3, 160), ValueError, r"out must be \(4, 160\)"),
    "dtype": (lambda: torch.empty(4, 160, dtype=torch.float64), TypeError, "out must be torch.float32"),
    "device": (lambda: torch.empty(4, 160, device="meta"), ValueError, "out on meta"),
    "non-contiguous": (lambda: torch.empty(160, 4).t(), ValueError, "contiguous"),
}


@pytest.mark.parametrize("fn", ["extract_windows", "extract_windows_plain"])
@pytest.mark.parametrize("bad", sorted(_BAD_OUT))
def test_out_is_checked(rng, bad, fn):
    """A caller's window of the wrong shape, dtype or device, or one that is
    not contiguous, raises; the wrapper and the plain version check alike."""
    fn = {"extract_windows": extract_windows, "extract_windows_plain": extract_windows_plain}[fn]
    rr, ri, offs, wlen = _case(rng, 3000, 160, [0, 5, 2999, -1])
    make, exc, match = _BAD_OUT[bad]
    with pytest.raises(exc, match=match):
        fn(torch.from_numpy(rr), torch.from_numpy(ri), torch.from_numpy(offs), wlen,
           out=(torch.empty(4, wlen), make()))


def test_window_sets_refuse_too_many_sets_or_pairs(rng):
    rr, ri, offs, _ = _case(rng, 3000, 0, [0, 5])
    args = (torch.from_numpy(rr), torch.from_numpy(ri), torch.from_numpy(offs))
    with pytest.raises(ValueError, match="1 to 4 window lengths"):
        extract_window_sets(*args, (8,) * 5)
    with pytest.raises(ValueError, match="2 window lengths but 1 output pairs"):
        extract_window_sets(*args, (8, 16), out=window_buffers(args[0], 2, (8,)))


def test_gather_bytes_counts_each_distinct_sample_once():
    """The bound of a gather (``profile_extract.gather_bytes``, which
    ``chip_smoke.py`` uses): every output byte, each input sample some window
    of some set covers once, clipped per set, and the offsets."""
    from cognitive_radio_network_tpu_torch.profile_extract import gather_bytes

    offs = torch.tensor([0, 100, 5000, -3, 9990])  # -3 and 9990 clip per set
    # covered: [0, 788) from the first two, [5000, 5688), and [9312, 10000)
    covered = 788 + 688 + 688
    want = 2 * 4 * 5 * (160 + 688) + 2 * 4 * covered + 5 * 8
    assert gather_bytes(offs, 10000, (160, 688)) == want
    assert gather_bytes(offs[:0], 10000, (160,)) == 0
