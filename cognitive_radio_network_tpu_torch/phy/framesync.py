"""OFDM frame synchronizer — the ``ofdmflexframesync`` capability, batched.

Port of ``cognitive_radio_network_tpu/phy/framesync.py``: the
fixed-configuration synchronizer and the block scan here, the adaptive
:class:`StreamReceiver` in :mod:`.stream` (re-exported below).  liquid's
synchronizer is a per-sample adaptive state machine (AGC, squelch, timing
PLL) driven inside ``ECR_rx_worker``'s hot loop
(src/extensible_cognitive_radio.cpp:1299-1366).  This design is
block-oriented and batched instead:

* **detect**: Schmidl&Cox autocorrelation metric over a whole IQ block at
  once finds S0 preambles, refines timing with a CFO-corrected matched
  filter, and estimates CFO from the autocorrelation phase;
* **demod**: CP strip, DFT across all symbols at once, one-shot channel
  estimate from S1, per-symbol pilot common-phase tracking, equalize,
  min-distance demod;
* **decode**: FEC (table codes as gathers, Viterbi as a loop over time) and
  CRC run batched on the device in the same pass, emitting a
  :class:`FrameSyncStats` record with the fields of the vendored
  framesyncstats contract (framesyncstats.c:39-55).

Window gathers (refinement windows, frame windows, header windows) go
through :func:`..ops.extract.extract_windows`, the CUDA kernel on the card.
Everything runs on the device of the input tensors; inputs that arrive on
the host (numpy, CPU tensors) go to the synchronizer's ``device``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.ops.extract import extract_windows
from cognitive_radio_network_tpu_torch.phy import crc as crc_mod
from cognitive_radio_network_tpu_torch.phy import fec as fec_mod
from cognitive_radio_network_tpu_torch.phy import modem
from cognitive_radio_network_tpu_torch.phy.bits import unpack_bits_tensor
from cognitive_radio_network_tpu_torch.phy.framegen import (
    HEADER_BYTES,
    TOTAL_HEADER_BYTES,
    _HEADER_CRC,
    _HEADER_FEC,
    _HEADER_MOD,
    OFDMFrameConfig,
    OFDMFrameGen,
    gen_for,
)
from cognitive_radio_network_tpu_torch.signal.iq import split_iq
from cognitive_radio_network_tpu_torch.utils.device import full_f32

__all__ = ["FrameSyncStats", "OFDMFrameSync", "StreamReceiver"]


@dataclasses.dataclass
class FrameSyncStats:
    """Per-frame receive statistics (framesyncstats.c:39-55 contract)."""

    evm: float  # error vector magnitude [dB]
    rssi: float  # received signal strength [dB]
    cfo: float  # carrier frequency offset [rad/sample]
    num_framesyms: int
    mod_scheme: str
    mod_bps: int
    check: str
    fec0: str
    fec1: str
    header_valid: bool
    payload_valid: bool


class OFDMFrameSync:
    """Fixed-configuration synchronizer (both sides share the frame config).

    Instances are cheap: the generator comes from the process-wide
    :func:`gen_for` cache, and device constants are cached per device.
    ``device`` is where host inputs (numpy arrays, CPU tensors) are moved:
    the card unless the caller asks for the CPU, and with no card the first
    such input raises.  CUDA tensors are processed where they lie."""

    def __init__(self, cfg: OFDMFrameConfig, payload_len: int,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.payload_len = payload_len
        self.gen = gen_for(cfg, payload_len)  # shares sizing/preambles
        self.device = torch.device(device)

    def _planes(self, iq) -> tuple[torch.Tensor, torch.Tensor]:
        re, im = split_iq(iq)
        if re.device.type == "cpu":
            re, im = re.to(self.device), im.to(self.device)
        return re, im

    # -- detection ------------------------------------------------------

    def detect(self, iq, threshold: float = 0.5):
        """Returns (peak_metric, best_offset, cfo) as 0-d tensors."""
        return _detect(self.gen, *self._planes(iq))

    # -- aligned demodulation ------------------------------------------

    def _stats_from(self, out: dict, i: int) -> FrameSyncStats:
        g = self.gen
        return FrameSyncStats(
            evm=float(out["evm_db"][i]),
            rssi=float(out["rssi_db"][i]),
            cfo=float(out["cfo"][i]),
            num_framesyms=g.num_symbols,
            mod_scheme=self.cfg.mod_scheme,
            mod_bps=g.bps,
            check=self.cfg.crc_scheme,
            fec0=self.cfg.fec0,
            fec1=self.cfg.fec1,
            header_valid=bool(out["hdr_ok"][i]),
            payload_valid=bool(out["pay_ok"][i]),
        )

    def demod_aligned(self, iq, cfo=None):
        """Frame-aligned IQ (B, frame_len) [complex, planes or planar] -> decoded.

        Returns (stats list[FrameSyncStats], headers (B,8), payloads (B,P)),
        the arrays as numpy.  Demod, FEC and CRC run in one batched pass."""
        re, im = self._planes(iq)
        if re.dim() == 1:
            re, im = re[None], im[None]
        b = re.shape[0]
        if cfo is None:
            cfo_t = torch.zeros(b, dtype=torch.float32, device=re.device)
        else:
            cfo_t = torch.as_tensor(cfo, dtype=torch.float32).to(re.device).reshape(b)
        out = _to_numpy(_rx_graph(self.gen, re, im, cfo_t))
        stats = [self._stats_from(out, i) for i in range(b)]
        return stats, out["headers"], out["payloads"]

    def decode_at(self, rr, ri, offsets, cfos) -> dict:
        """Batched gather+demod+decode at dynamic frame offsets.

        rr/ri: (N,) device planes; offsets/cfos: (G,).  Returns the rx dict
        of device tensors."""
        dev = rr.device
        return _rx_at_graph(
            self.gen, rr, ri,
            torch.as_tensor(offsets, dtype=torch.int64).to(dev),
            torch.as_tensor(cfos, dtype=torch.float32).to(dev),
        )

    def rx_block_fn(self, k: int = 16):
        """Fixed-config block receiver for up to ``k`` frames:
        (rr, ri, n_valid) -> (bests, peaks, cfos, rx dict, ok), all tensors
        on the planes' device, nothing fetched to the host, so calls
        queue back to back on the card.  ``n_valid`` is an int or a 0-d
        integer tensor."""
        return functools.partial(_receive_block_graph, self.gen, k=k)

    def receive_block(self, iq, threshold: float = 0.2, k: int = 16):
        """Host convenience over :meth:`rx_block_fn`: returns the frames
        decoded from one block as a list of {offset, stats, header, payload},
        sorted by offset, duplicates/overlaps suppressed."""
        re, im = self._planes(iq)
        n = re.shape[0]
        bests, peaks, cfos, out, ok = self.rx_block_fn(k)(re, im, n)
        bests, peaks, ok = (t.cpu().numpy() for t in (bests, peaks, ok))
        out = _to_numpy(out)
        frames, consumed_end = [], 0
        for i in np.argsort(bests, kind="stable"):
            off = int(bests[i])
            if peaks[i] < threshold or not ok[i] or off < consumed_end:
                continue
            frames.append(
                {
                    "offset": off,
                    "stats": self._stats_from(out, int(i)),
                    "header": out["headers"][i],
                    "payload": out["payloads"][i],
                }
            )
            consumed_end = off + self.gen.frame_len
        return frames

    def receive(self, iq, threshold: float = 0.2):
        """Detect + demod the first frame in a block (fixed config).

        Returns (offset, stats, header, payload), or four ``None`` when no
        preamble clears ``threshold`` or the frame overruns the block."""
        re, im = self._planes(iq)
        peak, best, cfo = _detect(self.gen, re, im)
        best = int(best)
        if float(peak) < threshold:
            return None, None, None, None
        fl = self.gen.frame_len
        if best + fl > re.shape[0]:
            return None, None, None, None
        frame = (re[None, best : best + fl], im[None, best : best + fl])
        stats, hdr, pay = self.demod_aligned(frame, cfo=cfo.reshape(1))
        return best, stats[0], hdr[0], pay[0]


def _to_numpy(out: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in out.items()}


@functools.lru_cache(maxsize=32)
def _dft_matrices(m: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of -2*pi*j*k/m, built in float64, stored float32."""
    ang = -2.0 * np.pi * np.outer(np.arange(m), np.arange(m)) / m
    return (
        torch.from_numpy(np.cos(ang).astype(np.float32)).to(device),
        torch.from_numpy(np.sin(ang).astype(np.float32)).to(device),
    )


def _cis(theta: torch.Tensor) -> torch.Tensor:
    """exp(1j * theta) as complex64."""
    return torch.complex(torch.cos(theta), torch.sin(theta))


def _n_valid(n_valid, device: torch.device) -> torch.Tensor:
    """The count of valid samples as a 0-d int64 tensor on ``device``, exact
    at any length.  An int gets there by a fill on the device, not by a copy
    from the host, which would wait for the stream's earlier work."""
    if isinstance(n_valid, torch.Tensor):
        return n_valid.to(device=device, dtype=torch.int64)
    return torch.full((), int(n_valid), dtype=torch.int64, device=device)


def _bucket_len(n: int, floor: int = 1) -> int:
    """The reference's shape bucket: the next multiple of an eighth of the
    enclosing power of two.  Nothing is compiled per shape here; the bucket is
    kept because the padded length decides how far back a refinement window
    near the buffer's end is clipped, and so which offsets the scan finds."""
    n = max(n, floor, 1)
    p = 1 << (n - 1).bit_length()
    q = max(p // 8, 1)
    return -(-n // q) * q


# ----------------------------------------------------------------------
# detection
# ----------------------------------------------------------------------


def _box3h(x: torch.Tensor, h: int) -> torch.Tensor:
    """Sliding sum of width 3h: ``y[t] = sum(x[t : t + 3h])``.

    For power-of-two h this is the reference's doubling ladder (log2 h
    shifted adds) plus a 3-term combine, in the same order, so the S&C
    metric agrees to the last bit of each add.  Tree-structured adds also
    avoid the cumsum-difference cancellation."""
    if h & (h - 1):  # non-power-of-two: cumsum difference fallback
        c = torch.cumsum(torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device), x]), 0)
        return c[3 * h :] - c[: -3 * h]
    s = x
    k = 1
    while k < h:
        s = s[:-k] + s[k:]
        k *= 2
    n = s.shape[0]
    return s[: n - 2 * h] + s[h : n - h] + s[2 * h :]


def _sc_metric(r: torch.Tensor, n_valid: torch.Tensor, m: int):
    """Schmidl&Cox plateau metric over a whole block.

    Returns (metric (N-ish,), p (autocorrelation sums), half).  Normalized
    by the energy of BOTH halves of the correlation window — one-sided
    normalization explodes when the early half is pure noise."""
    half = m // 2
    lag = r[half:] * torch.conj(r[:-half])
    win = 2 * m - half  # == 3 * half
    p = _box3h(lag, half)
    pw = r.abs() ** 2
    s3 = _box3h(pw, half)  # s3[t] = sum(pw[t : t + win])
    ln = p.shape[0]
    e1 = s3[:ln]
    e2 = s3[half : half + ln]
    # floor the energies at a fraction of the block's average window energy:
    # without it the ratio spikes at silence->signal boundaries (0/0)
    floor = 0.05 * win * pw.sum() / n_valid.clamp(min=1) + 1e-20
    metric = p.abs() ** 2 / (torch.maximum(e1, floor) * torch.maximum(e2, floor))
    # mask positions whose correlation window reaches past the valid samples
    idx = torch.arange(metric.shape[0], device=r.device)
    metric = torch.where(idx <= n_valid - (win + half), metric, -1.0)
    return metric, p, half


def _refine(rr, ri, metric, p, half, coarses, tmpl, m, cp=None):
    """CFO-corrected matched-filter timing refinement, vectorized over K
    coarse candidates.  The S&C metric plateaus (|P| and R shrink together
    during partial overlap), so snap to the known 2x-S0 template.  The
    candidates' windows come from one :func:`extract_windows` call."""
    tlen = tmpl.shape[0]
    # the box-smoothed S&C plateau maximum sits within ~cp + half of the
    # true start, so cp + m covers it with >= m/2 slack for any cp
    span = (cp if cp is not None else m) + m
    s_count = 2 * span + 1
    wlen = s_count - 1 + tlen
    cfo0 = torch.angle(p[coarses.clamp(0, p.shape[0] - 1)]) / half  # (K,)
    n = torch.arange(tlen, dtype=torch.float32, device=rr.device)
    rot = _cis(-cfo0[:, None] * n)
    base = (coarses - span).clamp(0, max(rr.shape[0] - wlen, 0))
    wr, wi = extract_windows(rr, ri, base, wlen)  # (K, wlen) each
    wins = torch.complex(wr, wi).unfold(1, tlen, 1)  # (K, S, tlen)
    q = rot * torch.conj(tmpl)[None, :]
    xc = (wins * q[:, None, :]).sum(dim=-1).abs() ** 2
    we = (wins.abs() ** 2).sum(dim=-1)
    fine = torch.argmax(xc / we.clamp(min=1e-12), dim=-1)
    best = base + fine
    cfo = torch.angle(p[best.clamp(0, p.shape[0] - 1)]) / half
    peak = metric[best.clamp(0, metric.shape[0] - 1)]
    return best, peak, cfo


def _detect_core(rr, ri, n_valid, tmpl, m: int):
    """S&C coarse detect + matched-filter fine timing of the strongest
    preamble: (peak, best, cfo) as 0-d tensors."""
    r = torch.complex(rr, ri)
    metric, p, half = _sc_metric(r, n_valid, m)
    coarse = torch.argmax(metric)
    best, peak, cfo = _refine(rr, ri, metric, p, half, coarse[None], tmpl, m)
    return peak[0], best[0], cfo[0]


def _topk_core(rr, ri, metric, p, half, tmpl, m, k: int, cp=None):
    """Top-K candidate detection, fully parallel: windowed local maxima
    (window 2m, which suppresses one frame's metric plateau — distinct
    frames are >= prefix_len >> 2m apart) -> non-max suppression against
    neighbor windows -> top K -> one vectorized refinement pass.
    Returns (bests (K',), peaks (K',), cfos (K',)) with K' = min(K, #windows).

    The top K is a stable descending sort, so equal values keep index
    order, as ``lax.top_k`` orders them."""
    w = 2 * m
    nwin = -(-metric.shape[0] // w)
    mm = torch.nn.functional.pad(metric, (0, nwin * w - metric.shape[0]), value=-1.0)
    wmax, warg = mm.reshape(nwin, w).max(dim=1)
    warg = warg + torch.arange(nwin, device=metric.device) * w
    inf = torch.full((1,), -float("inf"), device=metric.device)
    left = torch.cat([inf, wmax[:-1]])
    right = torch.cat([wmax[1:], inf])
    cand = (wmax >= left) & (wmax > right)  # ties resolve to the right window
    vals = torch.where(cand, wmax, -1.0)
    keff = min(k, nwin)
    topi = torch.sort(vals, descending=True, stable=True).indices[:keff]
    coarses = warg[topi]
    return _refine(rr, ri, metric, p, half, coarses, tmpl, m, cp=cp)


def _detect(gen: OFDMFrameGen, re: torch.Tensor, im: torch.Tensor):
    """Detection of the strongest preamble in one block: (peak, best, cfo).

    The block is zero-padded to the next power of two (at least 4m), as the
    reference pads it.  The padded length sets how far back a refinement
    window near the end is clipped, so any other padding can move the
    offset found for a preamble in the last few m samples."""
    m = gen.cfg.num_subcarriers
    n = re.shape[0]
    pad = (1 << (max(n, 4 * m) - 1).bit_length()) - n
    rr = torch.nn.functional.pad(re.float(), (0, pad))
    ri = torch.nn.functional.pad(im.float(), (0, pad))
    tmpl = gen.device_constants(rr.device)["tmpl"]
    return _detect_core(rr, ri, _n_valid(n, rr.device), tmpl, m)


# ----------------------------------------------------------------------
# demodulation and decode
# ----------------------------------------------------------------------


def _dft_mm(x: torch.Tensor, m: int) -> torch.Tensor:
    """DFT along the last axis (length m) as four real float32 matmuls, in
    full float32 (TF32 off), as the reference computes it at HIGHEST."""
    wre, wim = _dft_matrices(m, x.device)
    xr, xi = x.real.float(), x.imag.float()
    with full_f32():
        yr = xr @ wre - xi @ wim
        yi = xr @ wim + xi @ wre
    return torch.complex(yr, yi)


def _equalized_data_points(gen: OFDMFrameGen, r: torch.Tensor, cfo: torch.Tensor,
                           num_symbols: int):
    """r: (B, 2m + m+cp + num_symbols*(m+cp)) aligned at S0. Returns
    equalized data-subcarrier points (B, num_symbols, nd) and rssi (B,)."""
    cfg = gen.cfg
    m, cp = cfg.num_subcarriers, cfg.cp_len
    c = gen.device_constants(r.device)
    b = r.shape[0]
    n = torch.arange(r.shape[1], dtype=torch.float32, device=r.device)
    r = r * _cis(-cfo[:, None] * n)
    rssi = 10.0 * torch.log10((r.abs() ** 2).mean(dim=-1) + 1e-20)

    s1_start = 2 * m + cp
    s1_t = r[:, s1_start : s1_start + m]
    body = r[:, s1_start + m :]
    sym = body.reshape(b, num_symbols, m + cp)[:, :, cp:]

    y1 = _dft_mm(s1_t, m) / np.sqrt(m)
    x1 = c["s1_freq"]
    act = c["active_idx"]
    h = torch.ones((b, m), dtype=torch.complex64, device=r.device)
    h[:, act] = y1[:, act] * torch.conj(x1[act]) / (x1[act].abs() ** 2)

    y = _dft_mm(sym, m) / np.sqrt(m)
    yeq = y / (h[:, None, :] + 1e-12)

    if len(gen.pilot_idx):
        # the first num_symbols rows: pilot_sequence(num_symbols, n) is a
        # prefix of the frame's sequence
        pilots = c["pilots"][:num_symbols]
        dot = (yeq[:, :, c["pilot_idx"]] * torch.conj(pilots[None])).sum(dim=-1)
        yeq = yeq * _cis(-torch.angle(dot))[:, :, None]

    return yeq[:, :, c["data_idx"]], rssi


def _demod_graph(gen: OFDMFrameGen, re, im, cfo):
    """Full fixed-config frame demod. re/im: (B, frame_len)."""
    cfg = gen.cfg
    r = torch.complex(re.float(), im.float())
    b = r.shape[0]
    data, rssi = _equalized_data_points(gen, r, cfo, gen.num_symbols)
    hdr_pts = data[:, : gen.n_header_syms].reshape(b, -1)
    pay_pts = data[:, gen.n_header_syms :].reshape(b, -1)

    hdr_syms, hdr_evm = modem.demodulate(_HEADER_MOD, hdr_pts)
    pay_syms, pay_evm = modem.demodulate(cfg.mod_scheme, pay_pts)

    hdr_bits = hdr_syms[:, : gen.n_header_bits].to(torch.uint8)
    shifts = torch.arange(gen.bps - 1, -1, -1, dtype=torch.int32, device=r.device)
    pay_bits = ((pay_syms[:, :, None] >> shifts) & 1).reshape(b, -1).to(torch.uint8)[
        :, : gen.payload_enc_bytes * 8
    ]

    n_pay_syms_used = gen.payload_enc_bytes * 8 // gen.bps
    n_used = gen.n_header_bits + n_pay_syms_used
    evm_lin = (
        hdr_evm[:, : gen.n_header_bits].sum(dim=-1)
        + pay_evm[:, :n_pay_syms_used].sum(dim=-1)
    ) / n_used
    evm_db = 10.0 * torch.log10(evm_lin + 1e-20)
    return {
        "header_bits": hdr_bits,
        "payload_bits": pay_bits,
        "evm_db": evm_db,
        "rssi_db": rssi,
    }


def _header_demod_graph(gen: OFDMFrameGen, re, im, cfo):
    """Header-only demod over the fixed-size frame prefix."""
    r = torch.complex(re.float(), im.float())
    b = r.shape[0]
    data, rssi = _equalized_data_points(gen, r, cfo, gen.n_header_syms)
    hdr_syms, _ = modem.demodulate(_HEADER_MOD, data.reshape(b, -1))
    return hdr_syms[:, : gen.n_header_bits].to(torch.uint8), rssi


def _decode_header_graph(hdr_bits):
    """Coded header bits (B, n) -> (user (B,8), phy (B,6), crc_ok (B,))."""
    n_hdr_dec = TOTAL_HEADER_BYTES + crc_mod.crc_sizes(_HEADER_CRC)
    hdr_dec = fec_mod.decode_bits(_HEADER_FEC, hdr_bits, n_hdr_dec)
    hdr_ok = crc_mod.crc_check(_HEADER_CRC, hdr_dec)
    return (
        hdr_dec[:, :HEADER_BYTES],
        hdr_dec[:, HEADER_BYTES:TOTAL_HEADER_BYTES],
        hdr_ok,
    )


def _rx_graph(gen: OFDMFrameGen, re, im, cfo):
    """Fused frame receive: demod + header/payload FEC + CRC, batched.

    re/im: (B, frame_len).  Replaces the reference's per-frame host decode
    (liquid fec_decode + crc inside rxCallback,
    src/extensible_cognitive_radio.cpp:1385-1454)."""
    out = _demod_graph(gen, re, im, cfo)
    cfg = gen.cfg
    headers, phy, hdr_ok = _decode_header_graph(out["header_bits"])
    n_dec = gen.payload_len + crc_mod.crc_sizes(cfg.crc_scheme)
    n0 = fec_mod.encoded_length(cfg.fec0, n_dec)
    inner = fec_mod.decode_bits(cfg.fec1, out["payload_bits"], n0)
    pay_dec = fec_mod.decode_bits(cfg.fec0, unpack_bits_tensor(inner), n_dec)
    pay_ok = crc_mod.crc_check(cfg.crc_scheme, pay_dec)
    return {
        "headers": headers,
        "phy": phy,
        "payloads": pay_dec[:, : gen.payload_len],
        "hdr_ok": hdr_ok,
        "pay_ok": pay_ok,
        "evm_db": out["evm_db"],
        "rssi_db": out["rssi_db"],
        "cfo": cfo.float(),
    }


def _rx_at_graph(gen: OFDMFrameGen, rr, ri, offsets, cfos):
    """Gather frames at dynamic offsets from a block, then fused receive.

    rr/ri: (N,) planes; offsets (G,) int; cfos (G,) float32."""
    fre, fim = extract_windows(rr, ri, offsets, gen.frame_len)
    return _rx_graph(gen, fre, fim, cfos)


def _receive_block_graph(gen: OFDMFrameGen, rr, ri, n_valid, *, k: int):
    """Fixed-config block receive: top-K detect + gather + demod + FEC +
    CRC.  Returns (bests, peaks, cfos, rx dict, ok) where ok = header CRC &
    payload fits inside the valid samples.

    The replacement for liquid's per-sample streaming synchronizer at full
    rate (ofdmflexframesync_execute inside ECR_rx_worker,
    src/extensible_cognitive_radio.cpp:1299-1366)."""
    m = gen.cfg.num_subcarriers
    nv = _n_valid(n_valid, rr.device)
    metric, p, half = _sc_metric(torch.complex(rr, ri), nv, m)
    tmpl = gen.device_constants(rr.device)["tmpl"]
    bests, peaks, cfos = _topk_core(rr, ri, metric, p, half, tmpl, m, k, cp=gen.cfg.cp_len)
    out = _rx_at_graph(gen, rr, ri, bests, cfos)
    ok = out["hdr_ok"] & (bests + gen.frame_len <= nv)
    return bests, peaks, cfos, out, ok


def _scan_block_graph(layout: OFDMFrameGen, rr, ri, n_valid, *, k: int):
    """Block scan: top-K S&C candidates + header demod + header FEC/CRC
    decode for all K at once.

    Returns (bests, peaks, cfos, headers (K,8), phy (K,6), hdr_ok (K,))
    with hdr_ok False for candidates whose header region overruns the
    valid samples."""
    m = layout.cfg.num_subcarriers
    nv = _n_valid(n_valid, rr.device)
    metric, p, half = _sc_metric(torch.complex(rr, ri), nv, m)
    tmpl = layout.device_constants(rr.device)["tmpl"]
    bests, peaks, cfos = _topk_core(rr, ri, metric, p, half, tmpl, m, k, cp=layout.cfg.cp_len)
    pref = (
        2 * m
        + (m + layout.cfg.cp_len)
        + layout.n_header_syms * (m + layout.cfg.cp_len)
    )
    pre_r, pre_i = extract_windows(rr, ri, bests, pref)
    hdr_bits, _rssi = _header_demod_graph(layout, pre_r, pre_i, cfos)
    headers, phy, hdr_ok = _decode_header_graph(hdr_bits)
    hdr_ok = hdr_ok & (bests + pref <= nv)
    return bests, peaks, cfos, headers, phy, hdr_ok


# The adaptive receiver builds on everything above, so its module is imported
# last; ``from ...phy.framesync import StreamReceiver`` works as in the reference.
from cognitive_radio_network_tpu_torch.phy.stream import StreamReceiver  # noqa: E402
