"""Hard-decision Viterbi decoding of the K=7, rate-1/2 convolutional code (v27).

The trellis of the code (polynomials 0o171 and 0o133, liquid-dsp's
LIQUID_FEC_CONV_V27) is defined here; ``phy/fec.py`` encodes with it and
decodes through :func:`cognitive_radio_network_tpu_torch.phy.fec.viterbi_decode`.

The JAX package decodes with a ``lax.scan`` over the trellis
(``cognitive_radio_network_tpu/phy/fec.py``, ``viterbi_decode_jnp``); no TPU
kernel stands behind it.  :func:`viterbi_decode_plain` is that scan as a
PyTorch loop: one add-compare-select of all 64 states per step for every frame
at once, then a traceback loop.  It runs about five launches per step, so on a
card a 256-byte v27+v27 packet costs some 56,000 launches.
:func:`viterbi_decode_k7` runs the same recursion as one CUDA C++ kernel
launch per call, ``csrc/viterbi_k7.cu`` (one warp per frame, the frames side
by side), whose output is bit-equal to the plain version's.

The plain version is the only path for CPU tensors; ``viterbi_decode_k7``
takes CUDA tensors only and launches the kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.ops._launch import launch
from cognitive_radio_network_tpu_torch.utils import profiling
from cognitive_radio_network_tpu_torch.utils.device import on_cuda

__all__ = ["MAX_BITS", "frames_at_one_stride", "viterbi_decode_k7", "viterbi_decode_plain"]

_CONV_K = 7
_CONV_POLYS = (0o171, 0o133)
MAX_BITS = 1 << 30  # csrc/viterbi_k7.cu kMaxBits: decoded bits a frame may have


@functools.lru_cache(maxsize=None)
def _conv_tables():
    """next_state[state, bit], output_bits[state, bit] (2 bits packed)."""
    ns = np.zeros((64, 2), np.int32)
    out = np.zeros((64, 2), np.int32)
    for s in range(64):
        for b in range(2):
            reg = (b << 6) | s  # newest bit in MSB of the 7-bit window
            o = 0
            for g in _CONV_POLYS:
                o = (o << 1) | (bin(reg & g).count("1") & 1)
            ns[s, b] = reg >> 1
            out[s, b] = o
    return ns, out


@functools.lru_cache(maxsize=None)
def _conv_inverse():
    """Predecessors of each state: (inv_s, inv_b, inv_o), each (64, 2) int32:
    the previous state, the input bit and the expected 2-bit output."""
    ns, out = _conv_tables()
    inv = [[] for _ in range(64)]
    for s in range(64):
        for b in range(2):
            inv[ns[s, b]].append((s, b))
    inv_s = np.array([[p[0] for p in lst] for lst in inv], np.int32)
    inv_b = np.array([[p[1] for p in lst] for lst in inv], np.int32)
    return inv_s, inv_b, out[inv_s, inv_b].astype(np.int32)


@functools.lru_cache(maxsize=16)
def _viterbi_tables(device: torch.device):
    inv_s, inv_b, inv_o = _conv_inverse()
    return (
        torch.from_numpy(inv_s.astype(np.int64)).to(device),
        torch.from_numpy(inv_b.astype(np.uint8)).to(device),
        torch.from_numpy(inv_o).to(device),
    )


def viterbi_decode_plain(coded_bits: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Batched hard-decision Viterbi: coded bits (..., 2*(n_bits+6)) -> bits
    uint8 (..., n_bits), on the device of the input.

    Forward: one add-compare-select of all 64 states per time step, for
    every frame at once; the branch metrics of all steps are computed before
    the loop.  A tie keeps the first predecessor, as ``argmin`` does.
    Traceback: a loop backward over the stored selectors from state 0 (the
    tail flush).  Each call adds its host steps to the counter
    ``fec.viterbi_host_steps``."""
    dev = coded_bits.device
    inv_s, inv_b, inv_o = _viterbi_tables(dev)
    batch_shape = coded_bits.shape[:-1]
    t_total = n_bits + _CONV_K - 1
    profiling.count("fec.viterbi_host_steps", 2 * t_total)  # add-compare-select, then traceback
    flat = coded_bits.reshape(-1, coded_bits.shape[-1]).to(torch.int32)
    b = flat.shape[0]
    syms = (flat[:, 0 : 2 * t_total : 2] << 1) | flat[:, 1 : 2 * t_total : 2]  # (B, T)
    diff = syms[:, :, None, None] ^ inv_o  # (B, T, 64, 2)
    bm = (diff & 1) + (diff >> 1)  # Hamming distance of the 2-bit symbols
    pm = torch.full((b, 64), 1 << 20, dtype=torch.int32, device=dev)
    pm[:, 0] = 0
    sels = torch.empty((t_total, b, 64), dtype=torch.int64, device=dev)
    for t in range(t_total):
        cand = pm[:, inv_s] + bm[:, t]  # (B, 64, 2)
        sel = cand[..., 1] < cand[..., 0]
        pm = torch.where(sel, cand[..., 1], cand[..., 0])
        sels[t] = sel
    bits = torch.empty((t_total, b), dtype=torch.uint8, device=dev)
    state = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    for t in range(t_total - 1, -1, -1):
        sel = sels[t].gather(1, state)
        bits[t] = inv_b[state, sel][:, 0]
        state = inv_s[state, sel]
    return bits.T[:, :n_bits].reshape(*batch_shape, n_bits)


def frames_at_one_stride(coded_bits: torch.Tensor) -> bool:
    """Whether the kernel reads ``coded_bits`` (..., L) in place: each frame's
    bits at unit stride, and the frames at one stride (a contiguous tensor, or
    the first L bits of longer rows)."""
    rows = coded_bits.reshape(-1, coded_bits.shape[-1])  # a view wherever they are
    return rows.stride(1) == 1 and rows.data_ptr() == coded_bits.data_ptr()


def viterbi_decode_k7(coded_bits: torch.Tensor, n_bits: int) -> torch.Tensor:
    """:func:`viterbi_decode_plain`'s contract as one kernel launch, for
    uint8 coded bits (..., L) on a CUDA card with ``L >= 2 * (n_bits + 6)``.

    The frames are read in place where :func:`frames_at_one_stride` holds (a
    contiguous tensor, or a slice of the first L bits of longer rows, as the
    receiver's demodulator hands them over).  Raises ValueError for another
    dtype, a short input, frames it cannot read in place, an ``n_bits``
    outside ``[0, MAX_BITS]`` or a tensor off the card.  Launches on the
    current stream without synchronizing, with a scratch of 8 bytes per
    trellis step and frame for the selectors; each launch adds one to
    ``viterbi_decode_k7.launches`` and the frames it decodes to the counter
    ``fec.viterbi_kernel_frames``.  With no frame it launches nothing."""
    if coded_bits.dtype != torch.uint8:
        raise ValueError(f"kernel takes uint8 coded bits, got {coded_bits.dtype}")
    if not 0 <= n_bits <= MAX_BITS:
        raise ValueError(f"kernel decodes 0 to {MAX_BITS} bits a frame, got {n_bits}")
    if coded_bits.dim() < 1 or coded_bits.shape[-1] < 2 * (n_bits + _CONV_K - 1):
        raise ValueError(
            f"{n_bits} bits take {2 * (n_bits + _CONV_K - 1)} coded bits a frame, "
            f"got shape {tuple(coded_bits.shape)}"
        )
    if not frames_at_one_stride(coded_bits):
        raise ValueError("kernel takes coded bits at unit stride, the frames at one stride")
    if not on_cuda(coded_bits):
        raise ValueError(f"kernel takes coded bits on a CUDA card, got {coded_bits.device}")
    dev = coded_bits.device
    rows = coded_bits.reshape(-1, coded_bits.shape[-1])
    frames = rows.shape[0]
    out = torch.empty((*coded_bits.shape[:-1], n_bits), dtype=torch.uint8, device=dev)
    if frames == 0:
        return out
    padded = -(-(n_bits + _CONV_K - 1) // 32) * 32  # the kernel stores 32 steps at a time
    scratch = torch.empty((frames, padded, 2), dtype=torch.int32, device=dev)
    launch(
        "crn_viterbi_k7", dev,
        rows.data_ptr(), rows.stride(0), n_bits, frames, out.data_ptr(), scratch.data_ptr(),
    )
    viterbi_decode_k7.launches += 1
    profiling.count("fec.viterbi_kernel_frames", frames)
    return out


viterbi_decode_k7.launches = 0
