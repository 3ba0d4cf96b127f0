"""The adaptive streaming receiver: liquid's ``ofdmflexframesync`` in streaming use.

Port of the adaptive part of ``cognitive_radio_network_tpu/phy/framesync.py``
(the packed records, ``_phy_geometry``, ``_stream_step_graph`` and
``StreamReceiver``).  Only the OFDM geometry is fixed; each frame's payload
length, modulation, FEC and CRC ride in its coded PHY header, so the receiver
demodulates the fixed-size header region of every candidate first and then
decodes each frame under its own configuration.

Two ways to drive it:

* :meth:`StreamReceiver.process`, the host API: the residual lives on the
  host as float32 planes, it and each block are staged into a buffer kept per
  shape bucket and uploaded once, the block scan runs on the device (on a
  card, replayed from a CUDA graph captured once per shape:
  :class:`_ScanSlot`), its packed record comes back in one copy, candidates
  are resolved on the host and each payload configuration present is decoded
  in one batched pass (on a card replayed from a CUDA graph the slot keeps
  per payload configuration and group size), whose record comes back in one
  copy;
* :meth:`StreamReceiver.feed_device` / :meth:`StreamReceiver.flush` (and
  :meth:`StreamReceiver.process_device`, the synchronous form), the device API:
  the block's planes and all stream state live on the device and one call of
  :func:`_stream_step_graph` does the whole step (scan, candidate resolution,
  speculative decode, residual carry).  Nothing in a step waits for the
  device, so steps queue on the card one behind the other; their packed
  records go to pinned host memory in groups, by copies that run beside the
  next steps, and are read when a step falls ``max_lag`` behind.  The step
  is a :class:`StreamBank`'s: :meth:`StreamBank.feed` takes a block of each
  of B streams and runs one step for all of them, with the same launches
  whatever B is; :meth:`StreamReceiver.feed_device` is a bank of one stream.

Window gathers go through :func:`..ops.extract.extract_windows` and
:func:`..ops.extract.extract_window_sets` and the candidate walk through
:func:`..ops.resolve.resolve_candidates`: CUDA kernels on the card, their
plain versions on the CPU.  A device step gathers twice: the refinement
windows, then the header windows and every speculated configuration's frame
windows at the same offsets in one launch, into windows the receiver owns.
"""

from __future__ import annotations

import dataclasses
import functools
import threading

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.ops.extract import extract_window_sets, extract_windows
from cognitive_radio_network_tpu_torch.ops.resolve import resolve_candidates
from cognitive_radio_network_tpu_torch.ops.viterbi import viterbi_decode_k7
from cognitive_radio_network_tpu_torch.phy import crc as crc_mod
from cognitive_radio_network_tpu_torch.phy import fec as fec_mod
from cognitive_radio_network_tpu_torch.phy import modem
from cognitive_radio_network_tpu_torch.phy.framegen import (
    OFDMFrameConfig,
    OFDMFrameGen,
    gen_for,
    unpack_phy_header,
)
from cognitive_radio_network_tpu_torch.phy.framesync import (
    _bucket_len,
    _frame,
    _prefix_len,
    _refine_len,
    _rows,
    _rx_at_graph,
    _rx_graph,
    _scan_block_graph,
    _scan_candidates,
    _scan_headers,
    _window_buffers,
)
from cognitive_radio_network_tpu_torch.signal.iq import split_iq
from cognitive_radio_network_tpu_torch.utils import profiling

__all__ = ["StreamBank", "StreamReceiver"]


@functools.lru_cache(maxsize=512)
def _payload_gen(cfg: OFDMFrameConfig, key: tuple) -> OFDMFrameGen:
    """The generator of payload configuration ``key`` = (payload_len, mod,
    fec0, fec1, crc), as a PHY header names it, on ``cfg``'s OFDM geometry:
    one per process, as :func:`gen_for` keeps it."""
    payload_len, mod, f0, f1, check = key
    return gen_for(dataclasses.replace(cfg, mod_scheme=mod, fec0=f0, fec1=f1, crc_scheme=check),
                   payload_len)


def _max_residual(layout: OFDMFrameGen) -> int:
    """The most samples an adaptive receiver carries from one block to the
    next (a malformed stream's guard)."""
    return 4 * (_prefix_len(layout) + 64 * layout.cfg.symbol_len)


def _resolve_candidates(layout: OFDMFrameGen, bests, peaks, hdr_ok, phys, n: int, threshold: float):
    """The adaptive receive's acceptance walk on the host, over a block scan's
    fetched candidates in a buffer of ``n`` samples: order them by position,
    resolve each frame's configuration from its decoded PHY header, group the
    accepted ``(offset, candidate)`` pairs by configuration, and track the
    point an incomplete frame pulls the residual back to.

    Returns (accepted, consumed_end, keep_from, incomplete)."""
    prefix = _prefix_len(layout)
    # by default the residual keeps a preamble-sized tail; an incomplete frame
    # pulls it back to its start
    keep_from = max(n - prefix, 0)
    accepted: dict[tuple, list[tuple[int, int]]] = {}  # key -> [(off, cand)]
    consumed_end = 0
    incomplete = False
    attempted = 0
    for i in np.argsort(bests, kind="stable"):
        off, pk = int(bests[i]), float(peaks[i])
        if pk < threshold or off < consumed_end:
            continue
        attempted += 1
        if off + prefix > n:
            # header region incomplete; wait for more samples
            keep_from = min(keep_from, off)
            incomplete = True
            break
        if not hdr_ok[i]:
            continue  # false peak (or corrupted header): skip
        parsed = unpack_phy_header(phys[i])
        if parsed is None:
            continue
        flen = _payload_gen(layout.cfg, parsed).frame_len
        if off + flen > n:
            keep_from = min(keep_from, off)
            incomplete = True
            break  # frame incomplete; resume next block
        accepted.setdefault(parsed, []).append((off, int(i)))
        consumed_end = off + flen
    profiling.count("rx.candidates_attempted", attempted)
    profiling.count("rx.candidates_accepted", sum(map(len, accepted.values())))
    return accepted, consumed_end, keep_from, incomplete


# ----------------------------------------------------------------------
# packed records: one device->host copy per dispatch, not one per output
# ----------------------------------------------------------------------


def _bits_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 values -> the same bits as int32."""
    return x.float().contiguous().view(torch.int32)


def _scan_block_graph_packed(layout: OFDMFrameGen, rr, ri, n_valid, *, k: int) -> torch.Tensor:
    """:func:`_scan_block_graph` with its six outputs in one (K, 18) int32
    record (:func:`_pack_scan`)."""
    return _pack_scan(*_scan_block_graph(layout, rr, ri, n_valid, k=k))


def _pack_scan(bests, peaks, cfos, headers, phy, hdr_ok) -> torch.Tensor:
    """The block scan's six outputs in one (K, 18) int32 record: [best,
    peak.bits, cfo.bits, hdr_ok, header[8], phy[6]]."""
    cols = [
        bests.to(torch.int32)[:, None],
        _bits_i32(peaks)[:, None],
        _bits_i32(cfos)[:, None],
        hdr_ok.to(torch.int32)[:, None],
        headers.to(torch.int32),
        phy.to(torch.int32),
    ]
    return torch.cat(cols, dim=1)


def _unpack_scan(packed: np.ndarray):
    bests = packed[:, 0]
    peaks = np.ascontiguousarray(packed[:, 1]).view(np.float32)
    cfos = np.ascontiguousarray(packed[:, 2]).view(np.float32)
    hdr_ok = packed[:, 3].astype(bool)
    headers = packed[:, 4:12].astype(np.uint8)
    phy = packed[:, 12:18].astype(np.uint8)
    return bests, peaks, cfos, headers, phy, hdr_ok


def _rx_at_graph_packed(gen: OFDMFrameGen, rr, ri, offsets, cfos) -> torch.Tensor:
    """:func:`_rx_at_graph` with its outputs in one uint8 (G, 28 + P) record:
    [header[8], phy[6], payload[P], hdr_ok, pay_ok, evm_db, rssi_db, cfo],
    the three float32 columns as their bytes (:func:`_unpack_rx_record`)."""
    bytes_cols, f32_cols = _pack_rx(_rx_at_graph(gen, rr, ri, offsets, cfos))
    return torch.cat([bytes_cols, f32_cols.view(torch.uint8)], dim=1)


def _pack_rx(out: dict):
    """A fused receive's outputs in two arrays: uint8 (G, 16 + P) [header[8],
    phy[6], payload[P], hdr_ok, pay_ok] and float32 (G, 3) [evm_db, rssi_db,
    cfo]."""
    bytes_cols = [
        out["headers"],
        out["phy"],
        out["payloads"],
        out["hdr_ok"].to(torch.uint8)[:, None],
        out["pay_ok"].to(torch.uint8)[:, None],
    ]
    f32_cols = torch.stack([out["evm_db"], out["rssi_db"], out["cfo"]], dim=1)
    return torch.cat(bytes_cols, dim=1), f32_cols


def _unpack_rx(bytes_packed: np.ndarray, f32_packed: np.ndarray, payload_len: int) -> dict:
    b = np.asarray(bytes_packed)
    f = np.asarray(f32_packed)
    p = payload_len
    return {
        "headers": b[:, :8],
        "phy": b[:, 8:14],
        "payloads": b[:, 14 : 14 + p],
        "hdr_ok": b[:, 14 + p].astype(bool),
        "pay_ok": b[:, 15 + p].astype(bool),
        "evm_db": f[:, 0],
        "rssi_db": f[:, 1],
        "cfo": f[:, 2],
    }


def _unpack_rx_record(rec: np.ndarray, payload_len: int) -> dict:
    """A fetched record of :func:`_rx_at_graph_packed` as :func:`_unpack_rx`'s dict."""
    w = 16 + payload_len
    return _unpack_rx(rec[:, :w], np.ascontiguousarray(rec[:, w:]).view(np.float32), payload_len)


def _to_host(rec: torch.Tensor) -> torch.Tensor:
    """Start ``rec``'s copy to pinned host memory without waiting for it; a
    record on the CPU is the host's already."""
    if rec.device.type != "cuda":
        return rec
    host = torch.empty(rec.shape, dtype=rec.dtype, pin_memory=True)
    host.copy_(rec, non_blocking=True)
    return host


# ----------------------------------------------------------------------
# the adaptive stream step (scan + candidate resolution + speculative
# decode + residual carry), all on the device
# ----------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _geometry_tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(CRC bytes per CRC scheme, bits per symbol per modulation) on ``device``."""
    return (
        torch.tensor([crc_mod.crc_sizes(s) for s in crc_mod.SCHEMES], dtype=torch.int64).to(device),
        torch.tensor([modem.bits_per_symbol(s) for s in modem.SCHEMES], dtype=torch.int64).to(device),
    )


def _phy_geometry(layout: OFDMFrameGen, phy: torch.Tensor):
    """Frame geometry from decoded PHY headers, on the headers' device.

    phy: (K, 6) uint8 [payload_len lo | hi | mod | fec0 | fec1 | crc].
    Returns (frame_len (K,) int64, valid (K,) bool): ``unpack_phy_header`` and
    ``OFDMFrameGen``'s sizing for K headers at once, in integer arithmetic, so
    candidates resolve with each frame's TRUE length whichever payload
    configurations the block carries."""
    phy = phy.to(torch.int64)
    p = phy[:, 0] | (phy[:, 1] << 8)
    mod_i, f0_i, f1_i, crc_i = phy[:, 2], phy[:, 3], phy[:, 4], phy[:, 5]
    valid = (
        (mod_i < len(modem.SCHEMES))
        & (f0_i < len(fec_mod.SCHEMES))
        & (crc_i < len(crc_mod.SCHEMES))
        & (f1_i < len(fec_mod.SCHEMES))
    )
    crc_tab, bps_tab = _geometry_tables(phy.device)
    n_dec = p + crc_tab[crc_i.clamp(0, len(crc_mod.SCHEMES) - 1)]

    def fec_len(idx, nb):
        # encoded_length (phy/fec.py) per scheme, chosen element by element:
        # none, rep3, h74, h128, v27
        opts = torch.stack(
            [
                nb,
                3 * nb,
                (nb * 14 + 7) // 8,
                (nb * 12 + 7) // 8,
                (2 * (8 * nb + fec_mod._CONV_K - 1) + 7) // 8,
            ],
            dim=-1,
        )  # (K, 5)
        return opts.gather(1, idx.clamp(0, 4)[:, None])[:, 0]

    enc_bytes = fec_len(f1_i, fec_len(f0_i, n_dec))
    bps = bps_tab[mod_i.clamp(0, len(modem.SCHEMES) - 1)]
    total_mod_syms = (enc_bytes * 8 + bps - 1) // bps
    nd = len(layout.data_idx)
    n_payload_syms = (total_mod_syms + nd - 1) // nd
    m, cp = layout.cfg.num_subcarriers, layout.cfg.cp_len
    num_symbols = layout.n_header_syms + n_payload_syms
    return 2 * m + (m + cp) * (1 + num_symbols), valid


def _stream_step_graph(
    layout: OFDMFrameGen,
    spec_gens: tuple[OFDMFrameGen, ...],
    max_residual: int,
    res_r: torch.Tensor,
    res_i: torch.Tensor,
    res_len: torch.Tensor,
    blk_r: torch.Tensor,
    blk_i: torch.Tensor,
    thr: float,
    *,
    k: int,
    ws: dict | None = None,
):
    """One adaptive stream step on the device, with nothing fetched: scan +
    greedy candidate resolution + speculative decode + residual carry, for
    one stream or for a batch of B streams at once.

    The host semantics of :meth:`StreamReceiver.process` are reproduced
    exactly, for each stream on its own:

    * candidates ordered by position (stable), accepted greedily against the
      threshold, the header CRC, the header's validity, and overlap with the
      previously accepted frame using each candidate's TRUE frame length from
      its own PHY header (:func:`_phy_geometry`);
    * the incomplete-frame break (header region or frame overruns the buffer)
      stops acceptance and pulls the residual's keep point back to the frame's
      start, so the tail decodes with the next block;
    * the residual (right-aligned in an ``r_cap`` buffer, zeros before the
      keep point) is cut again on the device: the state never crosses to the
      host, so successive steps queue with no copy in between.

    A stream's buffer is ``cat(residual, block)`` of static length ``r_cap +
    len(block)``, scanned whole (``n_valid = n``), as in the reference: the
    S&C metric's floor, the top-K order and so the offsets depend on it.

    Payload decode runs speculatively against ``spec_gens`` (the 1-2 most
    recently seen payload configurations): every candidate is decoded under
    each, and ``match_idx`` says which (if any) equals its PHY header.  A
    frame that matches none (the configuration just changed) is decoded later
    by the host-grouped path on the returned buffer planes.  The header
    windows and every spec's frame windows are gathered at the scan's offsets
    in ONE launch (:func:`extract_window_sets`), each set clipped for its own
    length; with ``ws`` the step's windows (those and the refinement's) are
    the caller's, rewritten by each step (:func:`_window_buffers`).

    A batch lays its B buffers end to end for the gathers, so a step launches
    the same kernels whatever B is: two extract launches, one resolve launch
    (a walk per stream) and one decode per spec over all B * K candidates.
    The refinement windows are clipped into their own stream's buffer before
    the gather (:func:`_gather_rows`).  A header or frame window may run on
    into the next stream's buffer where the same window of a single stream
    would have been clipped back, but only for a candidate whose window
    overruns its own buffer, and no such window is ever read: a header
    region that overruns fails ``hdr_ok`` and stops the walk, and a frame
    accepted under spec ``s`` has the spec's length and lies whole inside its
    buffer (the walk takes no frame that overruns), so only the matched
    spec's bytes of accepted frames, which lie inside, are read.

    Shapes: one stream's residual planes (r_cap,), ``res_len`` 0-d int64 and
    block planes (n,); or a batch's (B, r_cap), (B,) and (B, n).  ``thr`` a
    Python float.  Returns (new_res_r, new_res_i, new_res_len, buf_r, buf_i,
    packed) with the batch's leading dimension where the inputs had it;
    ``packed`` is ONE int32 array (k+1, 10 + 2*S + ceil(W/4)) a stream: in
    columns 0..9+2S, rows 0..k-1 are [best, cfo.bits, accept, match_idx,
    phy[6], then per spec (evm, rssi).bits] and row k is the meta row
    [res_len_in, keep_from, consumed_end, incomplete, tiny, 0...]; the
    remaining columns are each candidate's MATCHED-spec decode bytes (uint8
    (k, W), W = max_s(16 + P_s), header, phy and ok flags included), four
    bytes to a word, little-endian.
    """
    if res_r.dim() == 1:  # one stream: a batch of one
        out = _stream_step_graph(layout, spec_gens, max_residual, res_r[None], res_i[None],
                                 res_len.reshape(1), blk_r[None], blk_i[None], thr, k=k, ws=ws)
        return tuple(t[0] for t in out)
    b, r_cap = res_r.shape
    dev = res_r.device
    buf_r = torch.cat([res_r, blk_r], dim=1)
    buf_i = torch.cat([res_i, blk_i], dim=1)
    n = buf_r.shape[1]  # static: r_cap + block_len
    lead = r_cap - res_len
    n_live = res_len + blk_r.shape[1]
    prefix = _prefix_len(layout)

    wlens = (prefix, *(sg.frame_len for sg in spec_gens))
    tlen = layout.device_constants(dev)["tmpl"].shape[0]
    m, cp = layout.cfg.num_subcarriers, layout.cfg.cp_len
    bufs = _window_buffers(ws, buf_r, b * k, (_refine_len(m, cp, tlen), *wlens))
    bests, peaks, cfos, nv = _scan_candidates(
        layout, buf_r, buf_i, n, k=k, ws=None if bufs is None else bufs[0])
    kk = bests.shape[1]
    at = bests + torch.arange(b, device=dev)[:, None] * n  # the buffers laid end to end
    wins = extract_window_sets(
        buf_r.reshape(-1), buf_i.reshape(-1), at.reshape(-1), wlens,
        out=None if bufs is None else [_rows(x, b * kk) for x in bufs[1:]])
    _headers, phy, hdr_ok = _scan_headers(layout, *wins[0], bests, cfos, nv)
    phy = phy.reshape(b * kk, 6)
    flen, phy_valid = _phy_geometry(layout, phy)

    # greedy resolution in offset order, each stream on its own (the host
    # loop of _resolve_candidates)
    order = torch.argsort(bests, dim=1, stable=True)
    keep0 = lead.clamp(min=n - prefix)
    good = hdr_ok & phy_valid.reshape(b, kk)
    acc_sorted, walk = resolve_candidates(
        bests.gather(1, order), peaks.float().gather(1, order), good.gather(1, order),
        flen.reshape(b, kk).gather(1, order), keep0, thr, n, prefix,
    )
    accept = torch.empty_like(acc_sorted).scatter_(1, order, acc_sorted)
    consumed_end, keep_from, incomplete = walk.unbind(1)

    # the tiny-block early-out of the host path: too short to scan -> accept
    # nothing, keep the whole live region, leave pending unchanged
    tiny = n_live < prefix + 4 * layout.cfg.num_subcarriers
    accept = accept & ~tiny[:, None]

    # residual carry (right-aligned, zeros before the keep point)
    keep2 = torch.maximum(keep_from, consumed_end).clamp(min=n - max_residual)
    keep2 = torch.where(tiny, lead, keep2)
    new_res_len = n - keep2
    live = torch.arange(r_cap, device=dev) >= (r_cap - new_res_len)[:, None]
    new_res_r = torch.where(live, buf_r[:, n - r_cap :], 0.0)
    new_res_i = torch.where(live, buf_i[:, n - r_cap :], 0.0)

    # speculative decode under each spec config, of all B * K candidates
    cf = cfos.reshape(-1)
    match_idx = torch.full((b * kk,), -1, dtype=torch.int32, device=dev)
    dec_bytes, dec_f32 = [], []
    for s, sg in enumerate(spec_gens):
        m_s = (phy == sg.device_constants(dev)["phy"]).all(dim=1)
        match_idx = torch.where((match_idx < 0) & m_s, s, match_idx)
        db, df = _pack_rx(_rx_graph(sg, *wins[1 + s], cf))
        dec_bytes.append(db)
        dec_f32.append(df)

    # The PHY header in the record comes from the SCAN, not from the decode
    # bytes: a mismatched candidate's speculative window (the spec's frame
    # length, possibly longer than the real frame) can clip at the buffer's
    # end and garble its row, and the fallback needs the exact header.
    cols = [
        bests.reshape(-1, 1).to(torch.int32),
        _bits_i32(cf)[:, None],
        accept.reshape(-1, 1).to(torch.int32),
        match_idx[:, None],
        phy.to(torch.int32),
        *(_bits_i32(df[:, :2]) for df in dec_f32),
    ]
    rec = torch.cat(cols, dim=1).reshape(b, kk, -1)  # (B, k, 10 + 2*S)
    meta = torch.zeros((b, 1, rec.shape[2]), dtype=torch.int32, device=dev)
    meta[:, 0, :5] = torch.stack([res_len, keep2, consumed_end, incomplete, tiny.to(torch.int64)], dim=1)
    # per candidate, keep ONLY the decode bytes of its MATCHED spec; unmatched
    # candidates default to spec 0's bytes, whose header columns are exact
    wp = -(-max(db.shape[1] for db in dec_bytes) // 4) * 4
    dec = torch.nn.functional.pad(dec_bytes[0], (0, wp - dec_bytes[0].shape[1]))
    for s, db in enumerate(dec_bytes[1:], start=1):
        dbp = torch.nn.functional.pad(db, (0, wp - db.shape[1]))
        dec = torch.where(match_idx[:, None] == s, dbp, dec)
    d32 = dec.contiguous().view(torch.int32).reshape(b, kk, -1)  # (B, k, wp / 4)
    packed = torch.cat(
        [torch.cat([rec, meta], dim=1), torch.nn.functional.pad(d32, (0, 0, 0, 1))], dim=2
    )
    return new_res_r, new_res_i, new_res_len, buf_r, buf_i, packed


# ----------------------------------------------------------------------
# the host API's block scan and group decode: one staging buffer per shape,
# and on a card one CUDA graph per shape
# ----------------------------------------------------------------------

_DECODE_GRAPHS = 16  # decode graphs a slot keeps; a group of another (config, G) decodes eagerly


class _ScanCache:
    """The process's block-scan slots, one per (device, layout, bucket) and
    shared by every receiver of the layout, and per card the one memory pool
    and capture stream of their graphs.  The graphs share the pool: replays
    are serialised by ``lock``, and each output is copied out before another
    graph replays, so a later graph may reuse what an earlier one freed.  One
    stream lets each capture reuse its predecessors' freed blocks.
    :meth:`StreamReceiver.process` holds ``lock`` from the block's staging to
    its decode's last read and its residual's copy out of the slot: the slot's
    buffers and its graphs' outputs are in use until then."""

    def __init__(self):
        self.lock = threading.Lock()
        self.slots: dict[tuple, _ScanSlot] = {}
        self._pools: dict[torch.device, tuple] = {}  # card -> (memory pool, capture stream)

    def slot(self, device: torch.device, layout: OFDMFrameGen, bucket: int) -> _ScanSlot:
        key = (device, layout, bucket)
        slot = self.slots.get(key)
        if slot is None:
            pool = None
            if device.type == "cuda":
                pool = self._pools.get(device)
                if pool is None:
                    pool = self._pools[device] = (torch.cuda.graph_pool_handle(), torch.cuda.Stream(device))
            slot = self.slots[key] = _ScanSlot(device, bucket, pool)
        return slot

    def clear(self) -> None:
        """Drop every slot and graph.  Later slots capture into a new pool:
        a pool whose graphs are all gone takes no new ones."""
        self.slots.clear()
        self._pools.clear()


_scan_cache = _ScanCache()


class _GroupGraph:
    """A decoded group's CUDA graph and its static inputs: the group's G
    offsets (int64) and CFOs (float32) in one device buffer, filled from a
    pinned host buffer by one asynchronous copy.  Each graph has its own
    inputs, so two groups of one call never share a host buffer whose copy
    may not have run yet."""

    def __init__(self, g: int, device: torch.device):
        self.host = torch.empty(3 * g, dtype=torch.int32, pin_memory=True)
        self.inputs = torch.empty(3 * g, dtype=torch.int32, device=device)
        self.offsets = self.inputs[: 2 * g].view(torch.int64)
        self.cfos = self.inputs[2 * g :].view(torch.float32)
        self.graph = self.out = self.launches = None  # set by the capture

    def load(self, offsets: np.ndarray, cfos: np.ndarray) -> None:
        h = self.host.numpy()
        h[: 2 * len(offsets)].view(np.int64)[:] = offsets
        h[2 * len(offsets) :].view(np.float32)[:] = cfos
        self.inputs.copy_(self.host, non_blocking=True)


class _ScanSlot:
    """The block scan's buffers for one (device, layout, bucket), and on a
    card the graphs of the scan and of the decode that read them.

    A block is staged into ``host`` (2, bucket) float32 planes, zero past its
    samples.  On the CPU ``host`` is the scan's input; on a card it is pinned
    and goes to the device ``planes`` in one asynchronous copy, with
    ``n_valid`` (0-d int64) filled on the device.  The scan there runs eagerly
    once per ``k`` (which fills the device tables' caches and warms cuBLAS),
    then is captured as a CUDA graph over these static inputs and replayed on
    every later call: the same kernels on the same inputs, so the same
    record.  The groups of accepted frames decode from the same planes in the
    same way, a graph per (payload config, group size) (:meth:`decode`).  A
    replay adds the extract and Viterbi kernels' launches in its graph to
    ``extract_windows.launches`` and ``viterbi_decode_k7.launches``, as the
    eager wrapper calls do."""

    def __init__(self, device: torch.device, bucket: int, pool: tuple | None):
        self.pool = pool  # the card's (memory pool, capture stream); None on the CPU
        self.graphs: dict[int, tuple] = {}  # k -> (graph, its packed record, its launches)
        self.decodes: dict[tuple, _GroupGraph] = {}  # (payload key, G) -> its graph
        if device.type == "cuda":
            self.planes = torch.empty((2, bucket), dtype=torch.float32, device=device)
            self.n_valid = torch.zeros((), dtype=torch.int64, device=self.planes.device)
            self.host = torch.empty((2, bucket), dtype=torch.float32, pin_memory=True)
        else:
            self.host = self.planes = torch.zeros((2, bucket), dtype=torch.float32)
            self.n_valid = None

    def stage(self, res: np.ndarray, re: torch.Tensor, im: torch.Tensor) -> None:
        """Stage [residual | block]: ``res`` (2, r) host planes, then the
        block's planes (on any device)."""
        r, n = res.shape[1], res.shape[1] + re.shape[0]
        h = self.host.numpy()
        h[:, :r] = res
        h[:, n:] = 0.0  # a longer block's samples may lie there
        self.host[0, r:n].copy_(re)
        self.host[1, r:n].copy_(im)

    def upload(self, n: int) -> torch.Tensor:
        if self.n_valid is not None:
            self.planes.copy_(self.host, non_blocking=True)
            self.n_valid.fill_(n)
        return self.planes

    def _capture(self, fn) -> tuple:
        """``fn()`` captured as a CUDA graph into the card's pool: (graph, its
        output, the extract and Viterbi launches it holds).  The capture runs
        nothing on the card, so what it added to the launch counters is taken
        off again, and its counts go to no span."""
        before = extract_windows.launches, viterbi_decode_k7.launches
        graph = torch.cuda.CUDAGraph()
        handle, side = self.pool
        # the capture binds this thread alone: another may allocate, launch
        # and synchronize on the card meanwhile (a node's transmit chain does)
        with profiling.uncounted(), torch.cuda.graph(graph, pool=handle, stream=side,
                                                     capture_error_mode="thread_local"):
            out = fn()
        launches = extract_windows.launches - before[0], viterbi_decode_k7.launches - before[1]
        extract_windows.launches -= launches[0]
        viterbi_decode_k7.launches -= launches[1]
        return graph, out, launches

    @staticmethod
    def _replay(graph, launches: tuple) -> None:
        graph.replay()
        extract_windows.launches += launches[0]
        viterbi_decode_k7.launches += launches[1]

    def scan(self, layout: OFDMFrameGen, n: int, k: int) -> torch.Tensor:
        """The packed scan record (:func:`_scan_block_graph_packed`) of the
        uploaded block of ``n`` samples."""
        rr, ri = self.planes[0], self.planes[1]
        if self.n_valid is None:
            return _scan_block_graph_packed(layout, rr, ri, n, k=k)
        entry = self.graphs.get(k)
        if entry is not None:
            graph, packed, launches = entry
            self._replay(graph, launches)
            profiling.count("rx.scan_graph_replays")
            return packed
        packed = _scan_block_graph_packed(layout, rr, ri, self.n_valid, k=k)
        self.graphs[k] = self._capture(lambda: _scan_block_graph_packed(layout, rr, ri, self.n_valid, k=k))
        profiling.count("rx.scan_graph_captures")
        return packed

    def decode(self, gen: OFDMFrameGen, key: tuple, offsets: np.ndarray, cfos: np.ndarray):
        """On a card, the packed receive record (:func:`_rx_at_graph_packed`)
        of the frames of payload config ``key`` (made by ``gen``) at
        ``offsets`` in the uploaded block: a replay of the group's graph, or
        on a new (key, G) the eager decode, then the graph's capture.  None
        once the slot holds ``_DECODE_GRAPHS`` graphs and the (key, G) is not
        among them: the caller decodes the group eagerly.  The record is the
        graph's own output, rewritten by the next replay of any graph in the
        pool: copy it out first.  Each replay counts the Viterbi kernel's
        frames as its launches would (each decodes the group's G frames)."""
        g = len(offsets)
        entry = self.decodes.get((key, g))
        if entry is None:
            if len(self.decodes) >= _DECODE_GRAPHS:
                return None
            entry = self.decodes[(key, g)] = _GroupGraph(g, self.planes.device)
        entry.load(offsets, cfos)
        if entry.graph is not None:
            self._replay(entry.graph, entry.launches)
            if entry.launches[1]:
                profiling.count("fec.viterbi_kernel_frames", entry.launches[1] * g)
            profiling.count("rx.decode_graph_replays")
            return entry.out
        rr, ri = self.planes[0], self.planes[1]
        rec = _rx_at_graph_packed(gen, rr, ri, entry.offsets, entry.cfos)
        entry.graph, entry.out, entry.launches = self._capture(
            lambda: _rx_at_graph_packed(gen, rr, ri, entry.offsets, entry.cfos))
        profiling.count("rx.decode_graph_captures")
        return rec


# ----------------------------------------------------------------------
# adaptive streaming receiver
# ----------------------------------------------------------------------


class StreamReceiver:
    """liquid-style adaptive receiver: only the OFDM geometry (subcarriers,
    CP, taper, allocation) is fixed; payload length/mod/FEC/CRC come from
    each frame's PHY header.  Feed arbitrary IQ blocks; frames straddling
    block boundaries are handled by a residual buffer.

    ``device`` is where host input is moved and where :meth:`process` scans
    and decodes: the card unless the caller asks for the CPU, and with no card
    the first block raises.  The device API takes planes that lie on that
    device already (a receiver made for ``"cuda"`` takes any card's) and moves
    host planes there; planes on another kind of device, or on another card
    than the one named, raise.  Use either :meth:`process` or the device API on one receiver:
    interleaving them is not supported (each keeps its own residual)."""

    def __init__(self, cfg: OFDMFrameConfig, max_frames_per_block: int = 16,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.layout = gen_for(cfg, 1)
        self.prefix_len = _prefix_len(self.layout)
        self.max_frames_per_block = max_frames_per_block
        # the host API's residual: (2, r) float32 planes on the host
        self._residual = np.zeros((2, 0), np.float32)
        self._residual_offset = 0  # absolute sample index of the residual's first sample
        # True while the residual holds a detected-but-incomplete frame (its
        # tail is still arriving): a squelch must not carry/skip past it
        self.pending_frame = False
        # the device API is a bank of this one stream (a StreamBank's streams
        # are the bank's instead)
        self._bank = StreamBank._of([self])

    # the device API's state lives in the receiver's bank
    @property
    def fetch_group(self) -> int:
        """Steps whose records are copied to the host in one transfer."""
        return self._bank.fetch_group

    @fetch_group.setter
    def fetch_group(self, steps: int) -> None:
        self._bank.fetch_group = steps

    @property
    def _spec_lru(self) -> list[tuple]:
        return self._bank._spec_lru

    @_spec_lru.setter
    def _spec_lru(self, keys: list[tuple]) -> None:
        self._bank._spec_lru = keys

    @property
    def _res_r_d(self):
        return self._bank._res_r

    @property
    def _res_len_d(self):
        return self._bank._res_len

    def skip(self, n: int) -> None:
        """Advance the stream cursor past ``n`` squelched samples without
        scanning them: the residual is discarded (by construction it carries
        no frame) and absolute offsets stay consistent across the gap."""
        self._residual_offset += self._residual.shape[1] + int(n)
        self._residual = np.zeros((2, 0), np.float32)
        self.pending_frame = False

    def carry(self, iq) -> None:
        """Advance past a squelched block WITHOUT scanning it, keeping an
        eighth-block + prefix tail in the residual: a frame whose head starts
        near the end of a cold block still decodes whole when the next hot
        block arrives."""
        block = torch.stack(split_iq(iq)).cpu().numpy()
        buf = np.concatenate([self._residual, block], axis=1)
        n = buf.shape[1]
        keep = min(self.prefix_len + block.shape[1] // 8, n)
        self._residual_offset += n - keep
        self._residual = buf[:, n - keep :]

    def process(self, iq, threshold: float = 0.2):
        """Append a block and extract every decodable frame.

        Returns a list of dicts: {offset, stats, header, payload} with
        ``offset`` the absolute sample index of the frame start.
        """
        with profiling.span("rx.process"), _scan_cache.lock:
            with profiling.span("rx.stage"):
                re, im = split_iq(iq)
                base = self._residual_offset
                n = self._residual.shape[1] + re.shape[0]
                if n < self.prefix_len + 4 * self.cfg.num_subcarriers:
                    self._residual = np.concatenate([self._residual, torch.stack((re, im)).cpu().numpy()],
                                                    axis=1)
                    return []

                # Scan the whole buffer for up to K frame candidates.  K is bounded
                # by physics: decodable frames are at least a header prefix apart.
                # The buffer is zero-padded to the reference's bucket and K follows
                # the bucket, so both packages scan the same shape.
                bucket = _bucket_len(n, 4 * self.cfg.num_subcarriers)
                keff = min(self.max_frames_per_block, max(4, -(-bucket // self.prefix_len)))
                slot = _scan_cache.slot(self.device, self.layout, bucket)
                slot.stage(self._residual, re, im)
            with profiling.span("rx.upload"):
                planes = slot.upload(n)  # the block's one upload
            with profiling.span("rx.scan"):
                packed = slot.scan(self.layout, n, keff)
            with profiling.span("rx.scan_read"):
                bests, peaks, cfos, _headers, phys, hdr_ok = _unpack_scan(packed.cpu().numpy())
            with profiling.span("rx.resolve"):
                accepted, consumed_end, keep_from, self.pending_frame = _resolve_candidates(
                    self.layout, bests, peaks, hdr_ok, phys, n, threshold
                )
            frames = self._decode_groups(planes[0], planes[1], accepted, cfos, base, slot)

            keep_from = max(keep_from, consumed_end, n - self.max_residual)
            # the slot is the layout's: copy the residual out before the lock goes
            self._residual = slot.host[:, keep_from:n].numpy().copy()
            self._residual_offset = base + keep_from
            return frames

    @property
    def max_residual(self) -> int:
        return _max_residual(self.layout)

    def _decode_groups(self, rr_d, ri_d, accepted, cfos, base, slot=None):
        """One batched demod+decode per payload config: every config is
        dispatched and its record's copy to the host started behind it, then
        the host waits once and reads them all.  On a card a group decoded
        from ``slot``'s planes replays the slot's graph for its (config, G)
        (:meth:`_ScanSlot.decode`); any other group there decodes eagerly and
        counts ``rx.decode_graph_eager``."""
        dev = rr_d.device
        pending = []
        with profiling.span("rx.decode"):
            for parsed, items in accepted.items():
                gen = _payload_gen(self.cfg, parsed)
                offs = np.asarray([off for off, _ in items], np.int64)
                cf = np.asarray([cfos[i] for _, i in items], np.float32)
                rec = slot.decode(gen, parsed, offs, cf) if slot is not None and dev.type == "cuda" else None
                if rec is None:
                    if dev.type == "cuda":
                        profiling.count("rx.decode_graph_eager")
                    rec = _rx_at_graph_packed(gen, rr_d, ri_d, torch.from_numpy(offs).to(dev),
                                              torch.from_numpy(cf).to(dev))
                pending.append((gen, items, _to_host(rec)))
        with profiling.span("rx.decode_read"):
            if dev.type == "cuda" and pending:
                torch.cuda.current_stream(dev).synchronize()
            frames = []
            for gen, items, rec in pending:
                # a copy: the pinned buffer goes back to the allocator
                out = _unpack_rx_record(rec.numpy().copy(), gen.payload_len)
                frames += [_frame(gen, out, j, base + off) for j, (off, _i) in enumerate(items)]
            frames.sort(key=lambda f: f["offset"])
        return frames

    def process_device(self, blk_r, blk_i, threshold: float = 0.2):
        """Device-resident streaming receive: like :meth:`process`, but the
        block planes are ALREADY on the device and ALL stream state (residual
        planes + length) lives there; the whole step is one call of
        :func:`_stream_step_graph`, and per block only the packed step record
        crosses to the host, never the samples.

        The semantics (candidate ordering, config resolution, residual carry,
        pending_frame) are those of :meth:`process`; interleaving the two APIs
        on one receiver is not supported.  Synchronous: the step's results are
        fetched before returning.  For throughput use :meth:`feed_device` +
        :meth:`flush`, which keep several steps in flight."""
        return self.feed_device(blk_r, blk_i, threshold, max_lag=0)

    def feed_device(self, blk_r, blk_i, threshold: float = 0.2, max_lag: int = 3):
        """Pipelined device-resident streaming: dispatch the stream step for
        this block and return the frames of any step whose results are due
        (more than ``max_lag`` steps behind).  The dispatch waits for nothing
        on the device; only reading a due step does.  Call :meth:`flush` to
        drain the tail; ``pending_frame`` is only current after a flush (or
        with ``max_lag=0``).  Planes that arrive on the host are moved to the
        receiver's device first, a copy that does wait.  The step is a
        :class:`StreamBank`'s at one stream."""
        re, im = split_iq((blk_r, blk_i))
        return self._own_bank().feed(re[None], im[None], threshold, max_lag)[0]

    def flush(self):
        """Drain every in-flight :meth:`feed_device` step; returns their
        frames and settles ``pending_frame``."""
        return self._own_bank().flush()[0]

    def _own_bank(self) -> StreamBank:
        if len(self._bank.receivers) != 1:
            raise RuntimeError("this receiver is a stream of a StreamBank: feed the bank")
        return self._bank

    def _fetch_step(self, entry, packed: np.ndarray):
        """Materialize this stream's frames of one step from its fetched
        record (k+1, W): ``entry`` is (spec, buf_r, buf_i, r_cap, row), the
        step's (B, n) buffer planes and this stream's row of them."""
        spec, buf_r, buf_i, r_cap, row = entry
        rec_w = 10 + 2 * len(spec)
        rec = packed[:, :rec_w]
        dec = np.ascontiguousarray(packed[:-1, rec_w:]).view(np.uint8)
        meta = rec[-1]
        rec = rec[:-1]
        res_len_in, keep2, _consumed, incomplete, tiny = meta[:5]
        lead = r_cap - int(res_len_in)
        base2 = self._residual_offset - lead
        self._residual_offset = base2 + int(keep2)
        if not tiny:
            self.pending_frame = bool(incomplete)
        bests = rec[:, 0]
        cfos = np.ascontiguousarray(rec[:, 1]).view(np.float32)
        accept = rec[:, 2].astype(bool)
        match_idx = rec[:, 3]
        # each candidate's dec row holds its MATCHED spec's decode bytes;
        # group rows per spec and unpack each group at its own width (the
        # per-candidate cfo is the scan's: the decode does not change it)
        spec_outs, spec_pos = [], []
        for s, key in enumerate(spec):
            rows = np.flatnonzero(accept & (match_idx == s))
            width = 16 + key[0]  # 14 + payload_len + 2 ok flags
            er = (
                np.ascontiguousarray(rec[rows, 10 + 2 * s : 12 + 2 * s])
                .view(np.float32)
                .reshape(len(rows), 2)
            )
            f32_s = np.column_stack([er, cfos[rows]])
            spec_outs.append((_payload_gen(self.cfg, key), _unpack_rx(dec[rows, :width], f32_s, key[0])))
            spec_pos.append({int(i): j for j, i in enumerate(rows)})
        frames = []
        fallback: dict[tuple, list[tuple[int, int]]] = {}
        acc_idx = np.flatnonzero(accept)  # iterate only accepted candidates
        for i in acc_idx[np.argsort(bests[acc_idx], kind="stable")]:
            off = int(bests[i])
            s = int(match_idx[i])
            if s >= 0:
                gen, out = spec_outs[s]
                frames.append(_frame(gen, out, spec_pos[s][int(i)], base2 + off))
                self._bank._touch_spec(spec[s])
            else:
                # the scan's exact PHY header (rec cols 4..10); accept implies
                # a header that parses (phy_valid in the step)
                parsed = unpack_phy_header(rec[i, 4:10].astype(np.uint8))
                fallback.setdefault(parsed, []).append((off, int(i)))
        profiling.count("rx.step_accepted", len(acc_idx))
        if fallback:
            profiling.count("rx.step_spec_misses", sum(map(len, fallback.values())))
            frames += self._decode_groups(buf_r[row], buf_i[row], fallback, cfos, base2)
            for key in fallback:
                self._bank._touch_spec(key)
            frames.sort(key=lambda f: f["offset"])
        return frames


class StreamBank:
    """B adaptive streams received together on the device: one
    :func:`_stream_step_graph` a block of every stream, so a step's launches
    do not grow with the number of streams.

    :meth:`feed` takes one block of each stream as (B, n) float32 planes (on
    the bank's device, or moved there) and dispatches one step for all of
    them, waiting for nothing on the device; it returns, per stream, the
    frames of the steps that are due (more than ``max_lag`` behind).
    :meth:`flush` drains every step still in flight.  Each stream keeps its
    own residual, offsets and ``pending_frame`` (``receivers[j]`` is stream
    j's :class:`StreamReceiver`, whose fallback decode it runs), and gets the
    frames B receivers fed the same blocks by
    :meth:`StreamReceiver.feed_device` would give.  The bank speculates on the
    payload configurations its streams' frames had last, at most 2, in one
    history for all streams, read in stream order; a frame of any other
    configuration is decoded by its stream's grouped host path.
    :meth:`StreamReceiver.feed_device` is a bank of one stream.

    Records of consecutive steps are stacked on the device and copied to
    pinned host memory in one transfer a group of ``fetch_group`` steps,
    which runs beside the next steps."""

    def __init__(self, cfg: OFDMFrameConfig, streams: int, max_frames_per_block: int = 16,
                 device: torch.device | str = "cuda"):
        if streams < 1:
            raise ValueError(f"a bank holds at least one stream, got {streams}")
        self._setup([StreamReceiver(cfg, max_frames_per_block, device) for _ in range(streams)])

    @classmethod
    def _of(cls, receivers: list) -> StreamBank:
        bank = cls.__new__(cls)
        bank._setup(receivers)
        return bank

    def _setup(self, receivers: list) -> None:
        first = receivers[0]
        self.receivers = receivers
        for rx in receivers:
            rx._bank = self
        self.cfg, self.device, self.layout = first.cfg, first.device, first.layout
        self.max_frames_per_block = first.max_frames_per_block
        # residual planes (B, r_cap) and lengths (B,) live on the device and
        # chain from step to step
        self._res_r = self._res_i = self._res_len = None
        # speculative-decode config history: the <= 2 most recently seen
        # payload configs (keys as in _payload_gen); the first guess is the
        # constructor's config at the reference's 256-byte packet size
        # (include/crts.hpp:192-194)
        cfg = self.cfg
        self._spec_lru: list[tuple] = [(256, cfg.mod_scheme, cfg.fec0, cfg.fec1, cfg.crc_scheme)]
        self._pending_steps: list[tuple] = []  # steps dispatched and not yet read
        # the step's windows (refinement, header and frame windows), kept
        # from step to step: steps run in order on one stream
        self._step_windows: dict = {}
        self.fetch_group = 8
        self._open_group: dict | None = None

    @property
    def pending_frame(self) -> list[bool]:
        """Per stream, :attr:`StreamReceiver.pending_frame` (current after a flush)."""
        return [rx.pending_frame for rx in self.receivers]

    def _device_planes(self, blk_r, blk_i) -> tuple[torch.Tensor, torch.Tensor]:
        """The blocks' planes on the bank's device: host planes are moved
        there, planes that lie elsewhere are refused (the fallback decode's
        synchronizers and the residual are the bank's device's)."""
        want = self.device
        planes = []
        for plane in split_iq((blk_r, blk_i)):
            got = plane.device
            if got.type == "cpu":
                plane = plane.to(want)
            elif got.type != want.type or (want.index is not None and got.index != want.index):
                raise ValueError(f"receiver on {want} was given planes on {got}")
            planes.append(plane)
        b = len(self.receivers)
        if planes[0].dim() != 2 or planes[0].shape[0] != b or planes[0].shape != planes[1].shape:
            raise ValueError(f"a bank of {b} streams takes ({b}, n) planes, got "
                             f"{tuple(planes[0].shape)} and {tuple(planes[1].shape)}")
        return planes[0], planes[1]

    def feed(self, blk_r, blk_i, threshold: float = 0.2, max_lag: int = 3) -> list[list[dict]]:
        """Dispatch one step over a block of every stream ((B, n) planes) and
        return, per stream, the frames of the steps that are due."""
        with profiling.span("rx.step"):
            blk_r, blk_i = self._device_planes(blk_r, blk_i)
            b, dev = blk_r.shape[0], blk_r.device
            r_cap = _bucket_len(_max_residual(self.layout))
            if self._res_r is None or self._res_r.device != dev:
                self._res_r = torch.zeros((b, r_cap), dtype=torch.float32, device=dev)
                self._res_i = torch.zeros((b, r_cap), dtype=torch.float32, device=dev)
                self._res_len = torch.zeros(b, dtype=torch.int64, device=dev)
            n = r_cap + int(blk_r.shape[1])
            keff = min(self.max_frames_per_block, max(4, -(-n // _prefix_len(self.layout))))
            spec = tuple(sorted(self._spec_lru[-2:]))
            spec_gens = tuple(_payload_gen(self.cfg, key) for key in spec)
            self._res_r, self._res_i, self._res_len, buf_r, buf_i, packed = _stream_step_graph(
                self.layout, spec_gens, _max_residual(self.layout),
                self._res_r, self._res_i, self._res_len, blk_r, blk_i, float(threshold), k=keff,
                ws=self._step_windows,
            )
            profiling.count("rx.step_streams", b)
            profiling.count("rx.step_candidates", b * (packed.shape[1] - 1))
            # group the step's packed record: one copy to the host per
            # fetch_group steps, running beside the next steps
            g = self._open_group
            if g is not None and g["arrs"] and g["arrs"][0].shape != packed.shape:
                self._submit_group()  # shape changed (new k/spec): close group
                g = None
            if g is None:
                g = self._open_group = {"arrs": [], "host": None, "done": None}
            idx = len(g["arrs"])
            g["arrs"].append(packed)
            self._pending_steps.append((g, idx, spec, buf_r, buf_i, r_cap))
            if len(g["arrs"]) >= self.fetch_group:
                self._submit_group()
        if len(self._pending_steps) > max_lag:
            return self._drain(len(self._pending_steps) - max_lag)
        return [[] for _ in self.receivers]

    def _submit_group(self) -> None:
        """Start the open group's copy to the host without waiting for it: on
        a card into pinned memory, with an event behind it that
        :meth:`_drain` waits on; on the CPU the stacked records are the
        host's already."""
        g = self._open_group
        if g is None or g["host"] is not None:
            return
        stacked = torch.stack(g["arrs"])
        if stacked.device.type == "cuda":
            host = torch.empty(stacked.shape, dtype=stacked.dtype, pin_memory=True)
            host.copy_(stacked, non_blocking=True)
            g["done"] = torch.cuda.Event()
            g["done"].record()
            g["host"] = host
        else:
            g["host"] = stacked
        g["arrs"] = []  # release per-step device refs (the stack holds the data)
        self._open_group = None

    def flush(self) -> list[list[dict]]:
        """Drain every in-flight step; returns each stream's frames and
        settles ``pending_frame``."""
        return self._drain(len(self._pending_steps))

    def _drain(self, count: int) -> list[list[dict]]:
        """Wait for the oldest ``count`` in-flight steps' records (their copies
        started when their groups closed) and materialize each stream's
        frames in stream order."""
        entries = self._pending_steps[:count]
        del self._pending_steps[:count]
        frames = [[] for _ in self.receivers]
        for g, idx, spec, buf_r, buf_i, r_cap in entries:
            with profiling.span("rx.step_fetch"):
                if g["host"] is None:  # partial group still open: copy it now
                    self._submit_group()
                if g["done"] is not None:
                    g["done"].synchronize()
                    g["done"] = None
                packed = g["host"].numpy()[idx]
                for j, rx in enumerate(self.receivers):
                    frames[j] += rx._fetch_step((spec, buf_r, buf_i, r_cap, j), packed[j])
        return frames

    def _touch_spec(self, key: tuple) -> None:
        """LRU update of the speculative-decode config history (cap 2)."""
        if self._spec_lru and self._spec_lru[-1] == key:
            return
        if key in self._spec_lru:
            self._spec_lru.remove(key)
        self._spec_lru.append(key)
        del self._spec_lru[:-2]
