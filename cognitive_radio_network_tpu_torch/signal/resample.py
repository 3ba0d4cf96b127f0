"""Rational polyphase resampling (the liquid ``resamp2``/``resamp`` capability).

Port of ``cognitive_radio_network_tpu/signal/resample.py``: the host numpy
functions are copied unchanged; :func:`resample_poly_torch` is the
counterpart of the reference's in-graph ``resample_poly_jnp`` (one gather
and one matmul on the tensors' device).

Used by the simulation medium to move node waveforms between their native
sample rates and the common medium rate (e.g. SU link at 1 MS/s inside a
13 MS/s band — scenarios/predictive_model.cfg:72-76), and by the interferer's
GMSK x2 interpolation (src/interferer.cpp:199-201).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.signal import filters
from cognitive_radio_network_tpu_torch.utils.device import full_f32

__all__ = ["resample_poly", "resample_poly_torch", "halfband_interp"]


@functools.lru_cache(maxsize=64)
def _resample_taps(up: int, down: int, taps_per_phase: int = 12) -> np.ndarray:
    cutoff = 0.5 / max(up, down)
    # length scales with max(up, down), NOT up: a decimator (up=1) needs its
    # anti-alias transition band to fit inside 1/down of the input rate, or
    # out-of-band signals fold into the output band (measured: a 13-tap
    # filter at down=16 left adjacent-channel transmitters only ~15 dB down
    # after decimation — every rx baseband carried aliased neighbors)
    n = max(up, down) * taps_per_phase
    n += (n % 2) == 0  # odd length, symmetric
    taps = filters.kaiser_lowpass_taps(n, cutoff, 70.0) * up
    return taps


@functools.lru_cache(maxsize=64)
def _decim_wmat(up: int, down: int, tpp: int) -> np.ndarray:
    """(tpp, 2*down, 2) interleaved-complex tap matrices for the pure-
    decimation sgemm fast path (see resample_poly): W[r, 2c, 0] and
    W[r, 2c+1, 1] both hold reversed-tap row r, column c."""
    taps = _resample_taps(up, down).astype(np.float32)
    hpad = np.zeros(tpp * down, np.float32)
    hpad[: len(taps)] = taps[::-1]
    hm = hpad.reshape(tpp, down)
    w = np.zeros((tpp, 2 * down, 2), np.float32)
    w[:, 0::2, 0] = hm
    w[:, 1::2, 1] = hm
    return w


def resample_poly(x, up: int, down: int):
    """Resample by up/down. complex or float, 1-D or (B, N) batched rows
    (each row resampled independently, on the host).

    Semantics: zero-stuff by ``up``, low-pass at min Nyquist (centered FIR,
    delay-compensated), take every ``down``-th.  Output length =
    ceil(len(x) * up / down).

    Implementation is TRUE POLYPHASE: only the taps that hit nonzero
    (stuffed) samples are touched, so the cost is taps_per_phase (~12) MACs
    per OUTPUT sample regardless of ``up`` — the naive zero-stuff+convolve
    would cost up*len(taps) per input (prohibitive for ratios like 65/7,
    the reference's 1.4 MS/s link inside the 13 MS/s medium,
    scenarios/predictive_model.cfg:40/:76).
    """
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == 1 and down == 1:
        return x
    taps = _resample_taps(up, down).astype(np.float32)
    xnp = np.asarray(x)
    n = xnp.shape[-1]
    want = -(-n * up // down)
    delay = (len(taps) - 1) // 2
    # out[m] = filt[m*down] with filt[i] = sum_q x[q] * taps[i + delay - up*q]
    # Let i = m*down + delay, phase p = i % up, base q0 = i // up:
    #   out[m] = sum_s x[q0 - s] * taps[p + up*s]
    tpp = -(-len(taps) // up)  # taps per phase
    if up == 1 and down > 1 and xnp.ndim == 1:
        # Pure decimation fast path: split the anti-alias FIR into `down`
        # phase branches of ~taps_per_phase taps and sum `down` short
        # correlations — the windowed-GEMM path below materializes a
        # (want, T)-sample window copy per block (measured ~1.2 ms per
        # 65536-sample medium block at down=16; this is ~0.2 ms).
        #   out[m] = sum_p sum_s taps[p + down*s] * x[down*(m-s) + delay-p]
        # y[m] = sum_j ht[j] * x[m*down + shift + j], ht = reversed taps,
        # shift = delay - T + 1.  Pad so every window starts on a multiple
        # of down, view the interleaved complex64 buffer as contiguous
        # float32 (rows, 2*down) blocks, and accumulate R = ceil(T/down)
        # shifted sgemms against (2*down, 2) interleaved tap matrices —
        # the (kk, 2) f32 result IS the interleaved complex output.  All
        # operands contiguous; no window copy (measured ~0.25 ms per
        # 65536-sample block at down=16 vs ~1.2 ms for the window GEMM).
        kk = want
        tlen = len(taps)
        nrows = -(-tlen // down)  # FIR rows per window (NOT tpp = T/up)
        shift = delay - tlen + 1
        lpad = down * nrows
        lpad += (-(shift + lpad)) % down
        rows_needed = (shift + lpad) // down + kk + nrows + 2
        rpad = max(rows_needed * down - (lpad + n), 0)
        xp = np.concatenate(
            [np.zeros(lpad, xnp.dtype), xnp, np.zeros(rpad, xnp.dtype)]
        )
        base = (shift + lpad) // down
        if xnp.dtype == np.complex64:
            xf = xp.view(np.float32).reshape(-1, 2 * down)
            w = _decim_wmat(up, down, nrows)
            acc = xf[base : base + kk] @ w[0]
            for r in range(1, nrows):
                acc += xf[base + r : base + r + kk] @ w[r]
            return acc.view(np.complex64)[:, 0]
        b2 = xp.reshape(-1, down)
        hpad = np.zeros(nrows * down, taps.dtype)
        hpad[:tlen] = taps[::-1]
        hmat = hpad.reshape(nrows, down).astype(xnp.dtype, copy=False)
        out = None
        for r in range(nrows):
            acc = b2[base + r : base + r + kk] @ hmat[r]
            out = acc if out is None else out + acc
        return out.astype(xnp.dtype, copy=False)
    # One BLAS GEMM instead of a (want, tpp) gather + einsum (the gather
    # materializes 12x the data and c_einsum runs scalar loops — measured
    # 13 ms per 65536-sample medium block, the distributed runtime's
    # dominant cost).  Group outputs into periods of ``up``: within one
    # period, column j has FIXED phase p_j = (j*down + delay) % up and
    # fixed window offset c_j = (j*down + delay) // up, so
    #   out[k, j] = sum_s xp[k*down + c_j - s] * phases[p_j, s]
    # is a strided window matrix (K, W) times a dense (W, up) tap matrix.
    W_mat, base, w_width = _poly_gemm_mat(up, down, delay, tpp)
    kk = -(-want // up)
    need = (kk - 1) * down + base + w_width  # last xp index touched + 1
    pad_r = max(need - (n + tpp), 0) + down
    if xnp.ndim == 2:
        b = xnp.shape[0]
        xp = np.concatenate(
            [
                np.zeros((b, tpp), xnp.dtype),
                np.ascontiguousarray(xnp),
                np.zeros((b, pad_r), xnp.dtype),
            ],
            axis=1,
        )
        it = xp.itemsize
        y = np.ascontiguousarray(  # overlapping strided views miss BLAS
            np.lib.stride_tricks.as_strided(
                xp[:, base:],
                shape=(b, kk, w_width),
                strides=(xp.strides[0], down * it, it),
            )
        )
        out = (y @ W_mat.astype(xnp.dtype)).reshape(b, kk * up)[:, :want]
    else:
        xp = np.concatenate(
            [np.zeros(tpp, xnp.dtype), xnp, np.zeros(pad_r, xnp.dtype)]
        )
        it = xp.itemsize
        y = np.ascontiguousarray(
            np.lib.stride_tricks.as_strided(
                xp[base:], shape=(kk, w_width), strides=(down * it, it)
            )
        )
        out = (y @ W_mat.astype(xnp.dtype)).reshape(kk * up)[:want]
    return out.astype(xnp.dtype)


@functools.lru_cache(maxsize=64)
def _poly_gemm_mat(up: int, down: int, delay: int, tpp: int):
    """Dense (W, up) tap matrix for the period-grouped polyphase GEMM.

    Column j holds phase (j*down + delay) % up, reversed and placed at its
    window offset; ``base`` is the xp index of window position 0 for k=0
    (already including the +tpp left-pad), ``W`` the window width."""
    taps = _resample_taps(up, down).astype(np.float32)
    tap_pad = np.zeros(up * tpp, np.float32)
    tap_pad[: len(taps)] = taps
    phases = tap_pad.reshape(tpp, up).T  # phases[p, s] = taps[p + up*s]
    c = (np.arange(up) * down + delay) // up
    p = (np.arange(up) * down + delay) % up
    cmin, cmax = int(c.min()), int(c.max())
    w_width = cmax - cmin + tpp
    base = cmin - (tpp - 1) + tpp  # xp index of window position 0 at k=0
    mat = np.zeros((w_width, up), np.float32)
    for j in range(up):
        # window position t holds xp[k*down + base + t]; tap s multiplies
        # xp[k*down + c_j - s + tpp]  =>  t = c_j + tpp - base - s
        t0 = int(c[j]) + tpp - base
        mat[t0 - np.arange(tpp), j] = phases[p[j]]
    return mat, base, w_width


@functools.lru_cache(maxsize=64)
def _poly_gemm_on(up: int, down: int, delay: int, tpp: int, device: torch.device):
    """:func:`_poly_gemm_mat`'s tap matrix on ``device``, built once."""
    mat, base, w_width = _poly_gemm_mat(up, down, delay, tpp)
    return torch.from_numpy(mat).to(device), base, w_width


def resample_poly_torch(x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """:func:`resample_poly` for batched float planes on any device.

    The same polyphase math and tap matrix as the host version (equal up to
    float32 summation order), as one gather and one matmul, in full float32
    (TF32 off).  ``x`` is (B, N) float32; the result is (B, ceil(N*up/down))
    on ``x``'s device."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == 1 and down == 1:
        return x
    taps = _resample_taps(up, down)
    n = x.shape[-1]
    want = -(-n * up // down)
    delay = (len(taps) - 1) // 2
    tpp = -(-len(taps) // up)
    w_mat, base, w_width = _poly_gemm_on(up, down, delay, tpp, x.device)
    kk = -(-want // up)
    need = (kk - 1) * down + base + w_width
    pad_r = max(need - (n + tpp), 0) + down
    xp = torch.nn.functional.pad(x, (tpp, pad_r))
    # window k is xp[k*down + base : k*down + base + w_width]: a strided view,
    # gathered into (B, kk, w_width) by the matmul's input copy
    y = xp[:, base : base + (kk - 1) * down + w_width].unfold(-1, w_width, down)
    with full_f32():
        out = torch.matmul(y, w_mat)
    return out.reshape(x.shape[0], kk * up)[:, :want]


def halfband_interp(x):
    """x2 interpolation (liquid resamp2_crcf_interp_execute equivalent)."""
    return resample_poly(x, 2, 1)
