"""Time-sharded OFDM link: frame-sync state across shard boundaries.

Port of ``cognitive_radio_network_tpu/parallel/phylink.py``.  liquid's
synchronizer carries opaque streaming state across every recv boundary
(src/extensible_cognitive_radio.cpp:1307), so a frame straddling two blocks
still decodes.  Sharded, the analog is overlap-save at frame scale: each time
shard of the IQ stream sends the head of its segment (a halo of a maximum
frame, or of a header prefix) to its left ring neighbour
(:func:`.collectives.ring_shift`), so a frame that starts near the end of
shard i and spills into shard i+1 is detected by shard i.  Ownership is by
frame start (``0 <= best < shard_len``), which also dedups detections between
neighbours.  The last shard's halo is shard 0's head brought round by the
ring, not stream data: its valid length stops at its own end.

Every rank is given the whole block and moves only its own segment to its
device (host input uploads only that).  Each rank runs the port's block
receive or block scan on its extended segment (the extract kernel gathers
the windows on the card), its fixed-size records are gathered into every
rank by one ``all_gather``, and the host loop that follows runs on every
rank: the frames come out on each.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from cognitive_radio_network_tpu_torch.ops.extract import extract_windows
from cognitive_radio_network_tpu_torch.parallel.collectives import (
    all_gather,
    axis_index,
    axis_size,
    psum,
    ring_shift,
)
from cognitive_radio_network_tpu_torch.phy.framegen import OFDMFrameConfig, gen_for
from cognitive_radio_network_tpu_torch.phy.framesync import (
    OFDMFrameSync,
    _accept_fixed,
    _bucket_len,
    _frame,
    _receive_block_graph,
    _rx_graph,
    _scan_block_graph,
    _to_numpy,
)
from cognitive_radio_network_tpu_torch.phy.stream import (
    _bits_i32,
    _max_residual,
    _pack_scan,
    _payload_gen,
    _prefix_len,
    _resolve_candidates,
    _unpack_scan,
)
from cognitive_radio_network_tpu_torch.signal.iq import split_iq

__all__ = ["ShardedFrameReceiver", "ShardedStreamReceiver"]


def _place(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``: the one way samples reach a rank's device here, so
    what a rank uploads is what passes through this call."""
    return x.to(device)


def _segment(parts, lo: int, length: int, device: torch.device) -> torch.Tensor:
    """Samples [lo, lo + length) of the concatenation of the 1-D tensors
    ``parts``, zero-padded past their end, on ``device``; only the pieces
    inside the range are moved there."""
    pieces, pos = [], 0
    for x in parts:
        a, b = max(lo - pos, 0), min(lo + length - pos, x.shape[0])
        if b > a:
            pieces.append(_place(x[a:b], device))
        pos += x.shape[0]
    got = sum(p.shape[0] for p in pieces)
    pieces.append(torch.zeros(length - got, dtype=torch.float32, device=device))
    return torch.cat(pieces).float()


def _extend(seg_r, seg_i, halo: int, mesh: DeviceMesh, axis: str):
    """This segment followed by the right neighbour's first ``halo`` samples
    (the ring shift ``i -> i - 1`` of every segment's head)."""
    head = torch.stack([seg_r[:halo], seg_i[:halo]])
    tail = ring_shift(head, mesh, axis, -1)
    return torch.cat([seg_r, tail[0]]), torch.cat([seg_i, tail[1]])


class ShardedFrameReceiver:
    """Fixed-config OFDM receiver sharded over a mesh ``time`` axis.

    The stream is split into equal contiguous segments, one per rank of
    ``time_axis``; each rank decodes every frame that STARTS inside its
    segment, including frames that straddle into the next shard (via the
    frame-length halo).  Decodes are those of the one-device receiver.
    ``device`` is where each rank works (the card unless the caller asks for
    the CPU)."""

    def __init__(
        self,
        cfg: OFDMFrameConfig,
        payload_len: int,
        mesh: DeviceMesh,
        *,
        time_axis: str = "time",
        k_per_shard: int = 16,
        device="cuda",
    ):
        self.cfg = cfg
        self.device = torch.device(device)
        self.sync = OFDMFrameSync(cfg, payload_len, device=self.device)
        self.mesh = mesh
        self.time_axis = time_axis
        self.k_per_shard = k_per_shard
        # halo: enough for a frame starting at the last owned sample PLUS the
        # detector's correlation lookahead (win + half ~ 2.5m) and the
        # refinement span (2m)
        self.halo = self.sync.gen.frame_len + 8 * cfg.num_subcarriers

    def receive(self, iq, threshold: float = 0.2):
        """Decode every frame in ``iq`` (complex, (N, 2) planes or an (re, im)
        pair; numpy or tensors; the whole block on every rank; padded with
        zeros to a multiple of the time axis's size).  Returns frames like
        :meth:`OFDMFrameSync.receive_block`: a list of {offset, stats,
        header, payload}, sorted by offset, on every rank."""
        re, im = split_iq(iq)
        d = axis_size(self.mesh, self.time_axis)
        idx = axis_index(self.mesh, self.time_axis)
        shard_len = -(-re.shape[0] // d)
        if shard_len < self.halo:
            raise ValueError(
                f"a shard of {shard_len} samples is shorter than the frame halo of {self.halo}"
            )
        start = idx * shard_len
        seg_r = _segment([re], start, shard_len, self.device)
        seg_i = _segment([im], start, shard_len, self.device)
        ext_r, ext_i = _extend(seg_r, seg_i, self.halo, self.mesh, self.time_axis)
        # the last shard's halo came round the ring from shard 0
        n_valid = shard_len if idx == d - 1 else shard_len + self.halo
        gen = self.sync.gen
        bests, peaks, cfos, out, ok = _receive_block_graph(
            gen, ext_r, ext_i, n_valid, k=self.k_per_shard
        )
        ok = ok & (bests < shard_len)  # ownership: the frame starts here
        cols = [
            (bests + start).to(torch.int32)[:, None],
            _bits_i32(peaks)[:, None],
            _bits_i32(out["cfo"])[:, None],
            _bits_i32(out["evm_db"])[:, None],
            _bits_i32(out["rssi_db"])[:, None],
            torch.stack([out["hdr_ok"], out["pay_ok"], ok], dim=1).to(torch.int32),
            out["headers"].to(torch.int32),
            out["payloads"].to(torch.int32),
        ]
        rec = all_gather(torch.cat(cols, dim=1), self.mesh, self.time_axis).cpu().numpy()
        f32 = np.ascontiguousarray(rec[:, 1:5]).view(np.float32)
        got = {
            "bests": rec[:, 0],
            "peaks": f32[:, 0],
            "cfo": f32[:, 1],
            "evm_db": f32[:, 2],
            "rssi_db": f32[:, 3],
            "hdr_ok": rec[:, 5].astype(bool),
            "pay_ok": rec[:, 6].astype(bool),
            "ok": rec[:, 7].astype(bool),
            "headers": rec[:, 8:16].astype(np.uint8),
            "payloads": rec[:, 16:].astype(np.uint8),
        }
        return [_frame(gen, got, i, int(got["bests"][i]))
                for i in _accept_fixed(got["bests"], got["peaks"], got["ok"], threshold, gen.frame_len)]


class ShardedStreamReceiver:
    """Adaptive (liquid-style) streaming receiver over a time-sharded mesh.

    The sharded counterpart of :class:`..phy.stream.StreamReceiver`: each
    frame's payload length / modulation / FEC / CRC ride its coded PHY header,
    and a residual buffer carries stream state across successive calls, so
    frames straddling block boundaries survive to the next call.

    Detection, the O(N) work, is sharded: each rank scans its segment of
    [residual | block] (top-K Schmidl&Cox, header demod, header FEC/CRC) with
    a header-prefix halo from its right neighbour; ownership is by frame
    start.  The candidates are gathered into every rank and resolved there by
    :func:`..phy.stream._resolve_candidates`, the walk
    :meth:`StreamReceiver.process` runs, so the acceptance rules live in one
    place.  Decode, the O(frames) work: each rank gathers
    the part of every accepted frame's window that lies in its segment (the
    extract kernel), zero-masks the rest, one sum over the time axis
    assembles whole windows, and every rank decodes them, one batched pass
    per payload configuration.  A rank holds O(n/d) of the stream.

    One residual store serves :meth:`receive`, :meth:`receive_device`,
    :meth:`carry` and :meth:`skip` (the reference's ``receive_device`` keeps a
    second store beside the offset it shares with ``receive``, so
    interleaving the two loses a frame that straddles the switch), and every
    per-call size is a :func:`..phy.framesync._bucket_len` length (the
    reference's ``_device_concat`` was keyed on the exact block size).
    ``device`` is where each rank works (the card unless the caller asks for
    the CPU)."""

    def __init__(
        self,
        cfg: OFDMFrameConfig,
        mesh: DeviceMesh,
        *,
        time_axis: str = "time",
        k_per_shard: int = 16,
        device="cuda",
    ):
        self.cfg = cfg
        self.device = torch.device(device)
        self.layout = gen_for(cfg, 1)
        self.prefix_len = _prefix_len(self.layout)
        # halo: header prefix + the detector's correlation lookahead
        # (win + half ~ 2.5m) + refinement span (2m)
        self.scan_halo = self.prefix_len + 8 * cfg.num_subcarriers
        self.mesh = mesh
        self.time_axis = time_axis
        self.k_per_shard = k_per_shard
        # the residual store: float32 planes on the device, the stream's
        # samples from _residual_offset on
        self._res_r = torch.zeros(0, dtype=torch.float32, device=self.device)
        self._res_i = torch.zeros(0, dtype=torch.float32, device=self.device)
        self._residual_offset = 0
        # same contract as StreamReceiver.pending_frame
        self.pending_frame = False

    @property
    def max_residual(self) -> int:
        return _max_residual(self.layout)

    def _keep(self, re, im, keep_from: int) -> None:
        """The residual becomes [residual | block][keep_from:]."""
        n = self._res_r.shape[0] + re.shape[0]
        self._res_r = _segment([self._res_r, re], keep_from, n - keep_from, self.device)
        self._res_i = _segment([self._res_i, im], keep_from, n - keep_from, self.device)

    def skip(self, n: int) -> None:
        """Advance past ``n`` squelched samples (same contract as
        :meth:`StreamReceiver.skip`)."""
        self._residual_offset += self._res_r.shape[0] + int(n)
        self._res_r = self._res_r[:0]
        self._res_i = self._res_i[:0]
        self.pending_frame = False

    def carry(self, iq) -> None:
        """Advance past a squelched block keeping an eighth-block + prefix
        residual tail (same contract as :meth:`StreamReceiver.carry`)."""
        re, im = split_iq(iq)
        n = self._res_r.shape[0] + re.shape[0]
        keep = min(self.prefix_len + re.shape[0] // 8, n)
        self._keep(re, im, n - keep)
        self._residual_offset += n - keep

    def receive(self, iq, threshold: float = 0.2):
        """Append a block of IQ (any form :func:`..signal.iq.split_iq` takes,
        the whole block on every rank) and extract every decodable frame;
        each rank moves only its segment to its device.

        Returns a list of {offset, stats, header, payload} with ``offset``
        the absolute sample index in the stream (across calls).  The host
        loop's semantics (candidate ordering, dedup, config grouping,
        residual carry) are :meth:`StreamReceiver.process`'s, so the frames
        are the one-device receiver's."""
        return self._receive(*split_iq(iq), threshold)

    def receive_device(self, blk_r, blk_i, threshold: float = 0.2):
        """:meth:`receive` for a block whose float32 planes lie on the
        receiver's device already: each rank takes views of its part of
        them, so nothing of the block is copied from the host.  Planes on
        another device raise ValueError."""
        want = self.device
        for plane in (blk_r, blk_i):
            got = plane.device
            if got.type != want.type or (want.index is not None and got.index != want.index):
                raise ValueError(f"receiver on {want} was given planes on {got}")
        return self._receive(blk_r.float(), blk_i.float(), threshold)

    def _receive(self, re, im, threshold):
        n = self._res_r.shape[0] + re.shape[0]
        base = self._residual_offset
        m = self.cfg.num_subcarriers
        if n < self.prefix_len + 4 * m:
            self._keep(re, im, 0)
            return []
        d = axis_size(self.mesh, self.time_axis)
        shard_len = _bucket_len(max(-(-n // d), self.scan_halo, 4 * m))
        start = axis_index(self.mesh, self.time_axis) * shard_len
        seg_r = _segment([self._res_r, re], start, shard_len, self.device)
        seg_i = _segment([self._res_i, im], start, shard_len, self.device)

        # the sharded scan; the valid-length clip also masks the last
        # shard's ring-wrapped halo (shard 0's head is not stream data there)
        ext_r, ext_i = _extend(seg_r, seg_i, self.scan_halo, self.mesh, self.time_axis)
        n_valid = min(max(n - start, 0), shard_len + self.scan_halo)
        bests, peaks, cfos, headers, phy, hdr_ok = _scan_block_graph(
            self.layout, ext_r, ext_i, n_valid, k=self.k_per_shard
        )
        own = bests < shard_len  # ownership: the frame starts in this segment
        rec = _pack_scan(
            bests + start, torch.where(own, peaks, -1.0), cfos, headers, phy, hdr_ok & own
        )
        rec = all_gather(rec, self.mesh, self.time_axis).cpu().numpy()
        bests, peaks, cfos, _headers, phys, hdr_ok = _unpack_scan(rec)

        accepted, consumed_end, keep_from, self.pending_frame = _resolve_candidates(
            self.layout, bests, peaks, hdr_ok, phys, n, threshold
        )
        frames = self._decode_accepted(accepted, cfos, seg_r, seg_i, start, base)
        keep_from = max(keep_from, consumed_end, n - self.max_residual)
        self._keep(re, im, keep_from)
        self._residual_offset = base + keep_from
        return frames

    def _decode_accepted(self, accepted, cfos, seg_r, seg_i, start: int, base: int):
        """One sharded window gather and batched decode per payload config:
        every rank cuts the part of each window that lies in its segment from
        the segment padded by a frame on both sides (the extract kernel),
        zeroes the samples it does not own, and one sum over the time axis
        gives every rank the whole windows, sample for sample."""
        shard_len = seg_r.shape[0]
        frames = []
        for parsed, items in accepted.items():
            gen = _payload_gen(self.cfg, parsed)
            flen = gen.frame_len
            offs = torch.tensor([off for off, _ in items], dtype=torch.int64).to(self.device)
            cf = torch.from_numpy(np.asarray([cfos[i] for _, i in items], np.float32)).to(self.device)
            pad_r = torch.nn.functional.pad(seg_r, (flen, flen))
            pad_i = torch.nn.functional.pad(seg_i, (flen, flen))
            rel = (offs - start + flen).clamp(0, shard_len + flen)
            wr, wi = extract_windows(pad_r, pad_i, rel, flen)  # (G, flen)
            gpos = offs[:, None] + torch.arange(flen, device=self.device)[None, :]
            owned = ((gpos >= start) & (gpos < start + shard_len))[None]
            wins = psum(torch.where(owned, torch.stack([wr, wi]), 0.0), self.mesh, self.time_axis)
            out = _to_numpy(_rx_graph(gen, wins[0], wins[1], cf))
            frames += [_frame(gen, out, j, base + off) for j, (off, _i) in enumerate(items)]
        frames.sort(key=lambda f: f["offset"])
        return frames
