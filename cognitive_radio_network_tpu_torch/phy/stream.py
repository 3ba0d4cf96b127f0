"""The adaptive streaming receiver: liquid's ``ofdmflexframesync`` in streaming use.

Port of the adaptive part of ``cognitive_radio_network_tpu/phy/framesync.py``
(the packed records, ``_phy_geometry``, ``_stream_step_graph`` and
``StreamReceiver``).  Only the OFDM geometry is fixed; each frame's payload
length, modulation, FEC and CRC ride in its coded PHY header, so the receiver
demodulates the fixed-size header region of every candidate first and then
decodes each frame under its own configuration.

Two ways to drive it:

* :meth:`StreamReceiver.process`, the host API: the residual lives on the
  host, each block is uploaded once, the block scan runs on the device, its
  packed record comes back in one copy, candidates are resolved on the host and
  each payload configuration present is decoded in one batched pass;
* :meth:`StreamReceiver.feed_device` / :meth:`StreamReceiver.flush` (and
  :meth:`StreamReceiver.process_device`, the synchronous form), the device API:
  the block's planes and all stream state live on the device and one call of
  :func:`_stream_step_graph` does the whole step (scan, candidate resolution,
  speculative decode, residual carry).  Nothing in a step waits for the
  device, so steps queue on the card one behind the other; their packed
  records go to pinned host memory in groups, by copies that run beside the
  next steps, and are read when a step falls ``max_lag`` behind.

Window gathers go through :func:`..ops.extract.extract_windows` and the
candidate walk through :func:`..ops.resolve.resolve_candidates`: CUDA kernels
on the card, their plain versions on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.ops.resolve import resolve_candidates
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
    OFDMFrameSync,
    _bucket_len,
    _rx_at_graph,
    _scan_block_graph,
)
from cognitive_radio_network_tpu_torch.signal.iq import split_iq

__all__ = ["StreamReceiver"]


# ----------------------------------------------------------------------
# packed records: one device->host copy per dispatch, not one per output
# ----------------------------------------------------------------------


def _bits_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 values -> the same bits as int32."""
    return x.float().contiguous().view(torch.int32)


def _scan_block_graph_packed(layout: OFDMFrameGen, rr, ri, n_valid, *, k: int) -> torch.Tensor:
    """:func:`_scan_block_graph` with its six outputs in one (K, 18) int32
    record: [best, peak.bits, cfo.bits, hdr_ok, header[8], phy[6]]."""
    bests, peaks, cfos, headers, phy, hdr_ok = _scan_block_graph(layout, rr, ri, n_valid, k=k)
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


def _rx_at_graph_packed(gen: OFDMFrameGen, rr, ri, offsets, cfos):
    """:func:`_rx_at_graph` with its outputs in two arrays: uint8 (G, 16 + P)
    [header[8], phy[6], payload[P], hdr_ok, pay_ok] and float32 (G, 3)
    [evm_db, rssi_db, cfo]."""
    out = _rx_at_graph(gen, rr, ri, offsets, cfos)
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


def _prefix_len(layout: OFDMFrameGen) -> int:
    """Samples from a frame's start to the end of its header symbols."""
    m, cp = layout.cfg.num_subcarriers, layout.cfg.cp_len
    return 2 * m + (m + cp) * (1 + layout.n_header_syms)


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
):
    """One adaptive stream step on the device, with nothing fetched: scan +
    greedy candidate resolution + speculative decode + residual carry.

    The host semantics of :meth:`StreamReceiver.process` are reproduced
    exactly:

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

    The buffer is ``cat(residual, block)`` of static length ``r_cap +
    len(block)``, scanned whole (``n_valid = n``), as in the reference: the
    S&C metric's floor, the top-K order and so the offsets depend on it.

    Payload decode runs speculatively against ``spec_gens`` (the 1-2 most
    recently seen payload configurations): every candidate is decoded under
    each, and ``match_idx`` says which (if any) equals its PHY header.  A
    frame that matches none (the configuration just changed) is decoded later
    by the host-grouped path on the returned buffer planes.

    ``res_len`` is a 0-d int64 tensor; ``thr`` a Python float.  Returns
    (new_res_r, new_res_i, new_res_len, buf_r, buf_i, packed) where ``packed``
    is ONE int32 array (k+1, 10 + 2*S + ceil(W/4)): in columns 0..9+2S, rows
    0..k-1 are [best, cfo.bits, accept, match_idx, phy[6], then per spec
    (evm, rssi).bits] and row k is the meta row [res_len_in, keep_from,
    consumed_end, incomplete, tiny, 0...]; the remaining columns are each
    candidate's MATCHED-spec decode bytes (uint8 (k, W), W = max_s(16 + P_s),
    header, phy and ok flags included), four bytes to a word, little-endian.
    """
    r_cap = res_r.shape[0]
    dev = res_r.device
    buf_r = torch.cat([res_r, blk_r])
    buf_i = torch.cat([res_i, blk_i])
    n = buf_r.shape[0]  # static: r_cap + block_len
    lead = r_cap - res_len
    n_live = res_len + blk_r.shape[0]
    prefix = _prefix_len(layout)

    bests, peaks, cfos, _headers, phy, hdr_ok = _scan_block_graph(layout, buf_r, buf_i, n, k=k)
    flen, phy_valid = _phy_geometry(layout, phy)

    # greedy resolution in offset order (the host loop of _resolve_candidates)
    order = torch.argsort(bests, stable=True)
    keep0 = lead.clamp(min=n - prefix).reshape(1)
    acc_sorted, walk = resolve_candidates(
        bests[order], peaks[order].float(), (hdr_ok & phy_valid)[order], flen[order], keep0,
        thr, n, prefix,
    )
    accept = torch.empty_like(acc_sorted)
    accept[order] = acc_sorted
    consumed_end, keep_from, incomplete = walk[0], walk[1], walk[2]

    # the tiny-block early-out of the host path: too short to scan -> accept
    # nothing, keep the whole live region, leave pending unchanged
    tiny = n_live < prefix + 4 * layout.cfg.num_subcarriers
    accept = accept & ~tiny

    # residual carry (right-aligned, zeros before the keep point)
    keep2 = torch.maximum(keep_from, consumed_end).clamp(min=n - max_residual)
    keep2 = torch.where(tiny, lead, keep2)
    new_res_len = n - keep2
    live = torch.arange(r_cap, device=dev) >= r_cap - new_res_len
    new_res_r = torch.where(live, buf_r[n - r_cap :], 0.0)
    new_res_i = torch.where(live, buf_i[n - r_cap :], 0.0)

    # speculative decode under each spec config
    match_idx = torch.full((bests.shape[0],), -1, dtype=torch.int32, device=dev)
    dec_bytes, dec_f32 = [], []
    for s, sg in enumerate(spec_gens):
        m_s = (phy == sg.device_constants(dev)["phy"]).all(dim=1)
        match_idx = torch.where((match_idx < 0) & m_s, s, match_idx)
        db, df = _rx_at_graph_packed(sg, buf_r, buf_i, bests, cfos)
        dec_bytes.append(db)
        dec_f32.append(df)

    # The PHY header in the record comes from the SCAN, not from the decode
    # bytes: a mismatched candidate's speculative window (the spec's frame
    # length, possibly longer than the real frame) can clip at the buffer's
    # end and garble its row, and the fallback needs the exact header.
    cols = [
        bests.to(torch.int32)[:, None],
        _bits_i32(cfos)[:, None],
        accept.to(torch.int32)[:, None],
        match_idx[:, None],
        phy.to(torch.int32),
        *(_bits_i32(df[:, :2]) for df in dec_f32),
    ]
    rec = torch.cat(cols, dim=1)  # (k, 10 + 2*S)
    meta = torch.zeros(rec.shape[1], dtype=torch.int32, device=dev)
    meta[:5] = torch.stack([res_len, keep2, consumed_end, incomplete, tiny.to(torch.int64)])
    # per candidate, keep ONLY the decode bytes of its MATCHED spec; unmatched
    # candidates default to spec 0's bytes, whose header columns are exact
    wp = -(-max(db.shape[1] for db in dec_bytes) // 4) * 4
    dec = torch.nn.functional.pad(dec_bytes[0], (0, wp - dec_bytes[0].shape[1]))
    for s, db in enumerate(dec_bytes[1:], start=1):
        dbp = torch.nn.functional.pad(db, (0, wp - db.shape[1]))
        dec = torch.where(match_idx[:, None] == s, dbp, dec)
    d32 = dec.contiguous().view(torch.int32)  # (k, wp / 4)
    packed = torch.cat(
        [torch.cat([rec, meta[None]]), torch.nn.functional.pad(d32, (0, 0, 0, 1))], dim=1
    )
    return new_res_r, new_res_i, new_res_len, buf_r, buf_i, packed


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
        self._syncs: dict[tuple, OFDMFrameSync] = {}
        self.max_frames_per_block = max_frames_per_block
        self._residual = np.zeros(0, np.complex64)
        self._residual_offset = 0  # absolute sample index of residual[0]
        # state of the device API: residual planes and length live on the
        # device and chain from step to step
        self._res_r_d = None
        self._res_i_d = None
        self._res_len_d = None
        # speculative-decode config history: the <= 2 most recently seen
        # payload configs (keys as in _sync_for); the first guess is the
        # constructor's config at the reference's 256-byte packet size
        # (include/crts.hpp:192-194)
        self._spec_lru: list[tuple] = [
            (256, cfg.mod_scheme, cfg.fec0, cfg.fec1, cfg.crc_scheme)
        ]
        self._pending_steps: list[tuple] = []  # steps dispatched and not yet read
        # consecutive steps' packed records are stacked on the device and
        # copied to the host in ONE transfer per group of this many steps
        self.fetch_group = 8
        self._open_group: dict | None = None
        # True while the residual holds a detected-but-incomplete frame (its
        # tail is still arriving): a squelch must not carry/skip past it
        self.pending_frame = False

    def _sync_for(self, payload_len, mod, f0, f1, check) -> OFDMFrameSync:
        key = (payload_len, mod, f0, f1, check)
        if key not in self._syncs:
            cfg = dataclasses.replace(
                self.cfg, mod_scheme=mod, fec0=f0, fec1=f1, crc_scheme=check
            )
            self._syncs[key] = OFDMFrameSync(cfg, payload_len, device=self.device)
        return self._syncs[key]

    @staticmethod
    def _host_block(iq) -> np.ndarray:
        """Any IQ form (complex, (N, 2) planes, an (re, im) pair; numpy or
        tensors on any device) -> host complex64."""
        re, im = split_iq(iq)
        return (re.cpu().numpy() + 1j * im.cpu().numpy()).astype(np.complex64)

    def skip(self, n: int) -> None:
        """Advance the stream cursor past ``n`` squelched samples without
        scanning them: the residual is discarded (by construction it carries
        no frame) and absolute offsets stay consistent across the gap."""
        self._residual_offset += len(self._residual) + int(n)
        self._residual = np.zeros(0, np.complex64)
        self.pending_frame = False

    def carry(self, iq) -> None:
        """Advance past a squelched block WITHOUT scanning it, keeping an
        eighth-block + prefix tail in the residual: a frame whose head starts
        near the end of a cold block still decodes whole when the next hot
        block arrives."""
        block = self._host_block(iq)
        buf = np.concatenate([self._residual, block])
        keep = min(self.prefix_len + len(block) // 8, len(buf))
        self._residual_offset += len(buf) - keep
        self._residual = buf[len(buf) - keep :]

    def process(self, iq, threshold: float = 0.2):
        """Append a block and extract every decodable frame.

        Returns a list of dicts: {offset, stats, header, payload} with
        ``offset`` the absolute sample index of the frame start.
        """
        buf = np.concatenate([self._residual, self._host_block(iq)])
        base = self._residual_offset
        n = len(buf)
        # position to keep from for the next block: by default just a
        # preamble-sized tail; an incomplete frame pulls it back to its start
        keep_from = max(n - self.prefix_len, 0)
        if n < self.prefix_len + 4 * self.cfg.num_subcarriers:
            self._residual = buf
            return []

        # Scan the whole buffer for up to K frame candidates.  K is bounded
        # by physics: decodable frames are at least a header prefix apart.
        # The buffer is zero-padded to the reference's bucket and K follows
        # the bucket, so both packages scan the same shape.
        bucket = _bucket_len(n, 4 * self.cfg.num_subcarriers)
        keff = min(self.max_frames_per_block, max(4, -(-bucket // self.prefix_len)))
        host = np.zeros((2, bucket), np.float32)
        host[0, :n] = buf.real
        host[1, :n] = buf.imag
        planes = torch.from_numpy(host).to(self.device)  # the block's one upload
        packed = _scan_block_graph_packed(self.layout, planes[0], planes[1], n, k=keff)
        bests, peaks, cfos, _headers, phys, hdr_ok = _unpack_scan(packed.cpu().numpy())

        accepted, consumed_end, keep_from = self._resolve_candidates(
            bests, peaks, hdr_ok, phys, n, threshold, keep_from
        )
        frames = self._decode_groups(planes[0], planes[1], accepted, cfos, base)

        keep_from = max(keep_from, consumed_end)
        # never let the residual grow beyond a bound (malformed stream guard)
        keep_from = max(keep_from, n - self.max_residual)
        self._residual = buf[keep_from:]
        self._residual_offset = base + keep_from
        return frames

    @property
    def max_residual(self) -> int:
        return 4 * (self.prefix_len + 64 * self.cfg.symbol_len)

    def _resolve_candidates(self, bests, peaks, hdr_ok, phys, n, threshold, keep_from):
        """Host side of the adaptive receive: order candidates by position,
        resolve per-frame configs from the decoded PHY headers, group by
        config, and track the incomplete-frame carry point."""
        accepted: dict[tuple, list[tuple[int, int]]] = {}  # key -> [(off, cand)]
        consumed_end = 0
        incomplete = False
        for i in np.argsort(bests, kind="stable"):
            off, pk = int(bests[i]), float(peaks[i])
            if pk < threshold or off < consumed_end:
                continue
            if off + self.prefix_len > n:
                # header region incomplete; wait for more samples
                keep_from = min(keep_from, off)
                incomplete = True
                break
            if not hdr_ok[i]:
                continue  # false peak (or corrupted header): skip
            parsed = unpack_phy_header(phys[i])
            if parsed is None:
                continue
            flen = self._sync_for(*parsed).gen.frame_len
            if off + flen > n:
                keep_from = min(keep_from, off)
                incomplete = True
                break  # frame incomplete; resume next block
            accepted.setdefault(parsed, []).append((off, int(i)))
            consumed_end = off + flen
        self.pending_frame = incomplete
        return accepted, consumed_end, keep_from

    def _decode_groups(self, rr_d, ri_d, accepted, cfos, base):
        """One batched demod+decode per payload config: every config is
        dispatched first, then the results are fetched."""
        dev = rr_d.device
        pending = []
        for parsed, items in accepted.items():
            sync = self._sync_for(*parsed)
            offs = torch.tensor([off for off, _ in items], dtype=torch.int64).to(dev)
            cf = torch.from_numpy(np.asarray([cfos[i] for _, i in items], np.float32)).to(dev)
            pending.append((sync, items, *_rx_at_graph_packed(sync.gen, rr_d, ri_d, offs, cf)))
        frames = []
        for sync, items, bpk, fpk in pending:
            out = _unpack_rx(bpk.cpu().numpy(), fpk.cpu().numpy(), sync.payload_len)
            for j, (off, _i) in enumerate(items):
                frames.append(
                    {
                        "offset": base + off,
                        "stats": sync._stats_from(out, j),
                        "header": out["headers"][j],
                        "payload": out["payloads"][j],
                    }
                )
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

    def _device_planes(self, blk_r, blk_i) -> tuple[torch.Tensor, torch.Tensor]:
        """The block's planes on the receiver's device: host planes are moved
        there, planes that lie elsewhere are refused (the fallback decode's
        synchronizers and the residual are the receiver's device's)."""
        want = self.device
        planes = []
        for plane in split_iq((blk_r, blk_i)):
            got = plane.device
            if got.type == "cpu":
                plane = plane.to(want)
            elif got.type != want.type or (want.index is not None and got.index != want.index):
                raise ValueError(f"receiver on {want} was given planes on {got}")
            planes.append(plane)
        return planes[0], planes[1]

    def feed_device(self, blk_r, blk_i, threshold: float = 0.2, max_lag: int = 3):
        """Pipelined device-resident streaming: dispatch the stream step for
        this block and return the frames of any step whose results are due
        (more than ``max_lag`` steps behind).  The dispatch waits for nothing
        on the device; only reading a due step does.  Call :meth:`flush` to
        drain the tail; ``pending_frame`` is only current after a flush (or
        with ``max_lag=0``).  Planes that arrive on the host are moved to the
        receiver's device first, a copy that does wait."""
        blk_r, blk_i = self._device_planes(blk_r, blk_i)
        dev = blk_r.device
        r_cap = _bucket_len(self.max_residual)
        if self._res_r_d is None or self._res_r_d.device != dev:
            self._res_r_d = torch.zeros(r_cap, dtype=torch.float32, device=dev)
            self._res_i_d = torch.zeros(r_cap, dtype=torch.float32, device=dev)
            self._res_len_d = torch.zeros((), dtype=torch.int64, device=dev)
        n = r_cap + int(blk_r.shape[0])
        keff = min(self.max_frames_per_block, max(4, -(-n // self.prefix_len)))
        spec = tuple(sorted(self._spec_lru[-2:]))
        spec_gens = tuple(self._sync_for(*key).gen for key in spec)
        (
            self._res_r_d,
            self._res_i_d,
            self._res_len_d,
            buf_r,
            buf_i,
            packed,
        ) = _stream_step_graph(
            self.layout, spec_gens, self.max_residual,
            self._res_r_d, self._res_i_d, self._res_len_d, blk_r, blk_i, float(threshold), k=keff,
        )
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
        return []

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

    def flush(self):
        """Drain every in-flight :meth:`feed_device` step; returns their
        frames and settles ``pending_frame``."""
        return self._drain(len(self._pending_steps))

    def _drain(self, count: int):
        """Wait for the oldest ``count`` in-flight steps' records (their copies
        started when their groups closed) and materialize their frames in
        stream order."""
        entries = self._pending_steps[:count]
        del self._pending_steps[:count]
        frames = []
        for entry in entries:
            g = entry[0]
            if g["host"] is None:  # partial group still open: copy it now
                self._submit_group()
            if g["done"] is not None:
                g["done"].synchronize()
                g["done"] = None
            frames += self._fetch_step(entry, g["host"].numpy()[entry[1]])
        return frames

    def _fetch_step(self, entry, packed: np.ndarray):
        """Materialize one step's frames from its fetched record."""
        _g, _idx, spec, buf_r, buf_i, r_cap = entry
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
            spec_outs.append((self._sync_for(*key), _unpack_rx(dec[rows, :width], f32_s, key[0])))
            spec_pos.append({int(i): j for j, i in enumerate(rows)})
        frames = []
        fallback: dict[tuple, list[tuple[int, int]]] = {}
        acc_idx = np.flatnonzero(accept)  # iterate only accepted candidates
        for i in acc_idx[np.argsort(bests[acc_idx], kind="stable")]:
            off = int(bests[i])
            s = int(match_idx[i])
            if s >= 0:
                sync, out = spec_outs[s]
                j = spec_pos[s][int(i)]
                frames.append(
                    {
                        "offset": base2 + off,
                        "stats": sync._stats_from(out, j),
                        "header": out["headers"][j],
                        "payload": out["payloads"][j],
                    }
                )
                self._touch_spec(spec[s])
            else:
                # the scan's exact PHY header (rec cols 4..10); accept implies
                # a header that parses (phy_valid in the step)
                parsed = unpack_phy_header(rec[i, 4:10].astype(np.uint8))
                fallback.setdefault(parsed, []).append((off, int(i)))
        if fallback:
            frames += self._decode_groups(buf_r, buf_i, fallback, cfos, base2)
            for key in fallback:
                self._touch_spec(key)
            frames.sort(key=lambda f: f["offset"])
        return frames

    def _touch_spec(self, key: tuple) -> None:
        """LRU update of the speculative-decode config history (cap 2)."""
        if self._spec_lru and self._spec_lru[-1] == key:
            return
        if key in self._spec_lru:
            self._spec_lru.remove(key)
        self._spec_lru.append(key)
        del self._spec_lru[:-2]
