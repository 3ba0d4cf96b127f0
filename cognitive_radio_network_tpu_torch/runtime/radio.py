"""The radio runtime — port of ``ExtensibleCognitiveRadio`` (ECR).

Where the reference runs three pthreads against two USRP handles
(src/extensible_cognitive_radio.cpp:46-260), this Radio is a synchronous
block-stepped state machine driven by the node runtime: the simulation medium
hands it receive blocks and pulls transmit blocks; engines execute on events
between blocks.  The public parameter API mirrors the ECR's ~80
setters/getters (include/extensible_cognitive_radio.hpp:52-985), including
the double-buffered "params updated, applied at the worker loop" semantics
(update_tx_params src/extensible_cognitive_radio.cpp:829-881): setter calls
mark the config dirty and the tx/rx chains are rebuilt at the next block
boundary.

Port of ``cognitive_radio_network_tpu/runtime/radio.py``.  The rx front end
(mixer, receiver noise, decimation, squelch) is numpy on the host, as in the
reference.  The tx chain (frame assembly, gain, polyphase resampling to the
medium rate) runs on the radio's device with one copy of the samples back,
and the receiver is :class:`StreamReceiver` on that device, whose block
scan and decodes launch the extract kernel there.
"""

from __future__ import annotations

import dataclasses
import functools
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.env.channel import soft_gain
from cognitive_radio_network_tpu_torch.phy.framegen import OFDMFrameConfig, OFDMFrameGen, gen_for
from cognitive_radio_network_tpu_torch.phy.stream import StreamReceiver
from cognitive_radio_network_tpu_torch.runtime.engine import CEEvent, CEMetrics, FrameType
from cognitive_radio_network_tpu_torch.runtime.stats import RxStatistics
from cognitive_radio_network_tpu_torch.signal.resample import (
    resample_poly,
    resample_poly_torch,
)
from cognitive_radio_network_tpu_torch.utils.device import require_device

__all__ = ["RadioParams", "Radio", "TX_STOPPED", "TX_CONTINUOUS"]

TX_STOPPED = 0
TX_CONTINUOUS = 1


@functools.lru_cache(maxsize=1)
def _noise_pool() -> np.ndarray:
    """Process-wide unit-variance complex Gaussian pool (32 MB); radios
    draw noise as random slices with their own rngs (_noise_slice)."""
    rng = np.random.default_rng(0xC0FFEE)
    return rng.standard_normal((1 << 22, 2), dtype=np.float32).view(
        np.complex64
    )[:, 0]


@functools.lru_cache(maxsize=128)
def _mix_ramp(off: float, n: int) -> np.ndarray:
    """One period of the digital mixer phasor exp(2j*pi*off*arange(n)).

    Tune frequencies and block lengths are stable across a run, so the
    65536-point complex exp (~2 ms per block per node, the mixer's entire
    cost) is computed once; each block then pays one multiply pass plus a
    scalar rotator for phase continuity."""
    return np.exp(2j * np.pi * off * np.arange(n)).astype(np.complex64)


@functools.lru_cache(maxsize=256)
def _soft_gain_f(gain_db: float) -> float:
    """float(soft_gain(db)), cached: the node loop asks for it twice per
    frame batch and gains change rarely; the cache preserves the exact f32
    value."""
    return float(soft_gain(gain_db))


@functools.lru_cache(maxsize=256)
def _tx_chain_fn_for(
    cfg: OFDMFrameConfig, payload_len: int, up: int, down: int, device: torch.device
) -> Callable:
    """The assemble->gain->resample chain for one (frame config, payload
    length, rate ratio, device): frames assembled on ``device`` from the
    coded bits, scaled by the gain, resampled to the medium rate by the
    polyphase matmul, then ONE copy of the (B, L, 2) float32 planes to the
    host.  Keyed on the same (cfg, payload_len) tuple as ``gen_for``'s own
    cache, so identically-configured radios share one chain."""
    gen = gen_for(cfg, payload_len)

    @torch.no_grad()
    def fn(hdr_bits: np.ndarray, pay_bits: np.ndarray, gain: np.float32) -> np.ndarray:
        pl = gen.assemble_bits(hdr_bits, pay_bits, as_planes=True, device=device) * float(gain)
        if (up, down) != (1, 1):
            pl = torch.stack(
                [
                    resample_poly_torch(pl[..., 0], up, down),
                    resample_poly_torch(pl[..., 1], up, down),
                ],
                dim=-1,
            )
        return pl.cpu().numpy()

    return fn


def _mix(block: np.ndarray, off: float, cursor: int) -> np.ndarray:
    """Phase-continuous mix of ``block`` by ``off`` cycles/sample starting
    at absolute sample index ``cursor``.  Two passes, one allocation: the
    scalar rotator is applied in place (the previous ramp*rot pass cost a
    third pass + allocation per block per node)."""
    if off == 0.0:
        return block
    rot = np.complex64(np.exp(2j * np.pi * ((off * cursor) % 1.0)))
    out = block * _mix_ramp(off, len(block))
    out *= rot
    return out


@dataclasses.dataclass
class RadioParams:
    """tx/rx parameter struct mirroring ECR defaults
    (src/extensible_cognitive_radio.cpp:52-78, :100-104)."""

    tx_freq: float = 460.0e6
    tx_rate: float = 1e6
    tx_gain: float = 0.0  # UHD gain [dB]
    tx_gain_soft: float = -12.0
    tx_subcarriers: int = 32
    tx_cp_len: int = 16
    tx_taper_len: int = 4
    tx_modulation: str = "qam4"
    tx_crc: str = "crc32"
    tx_fec0: str = "h128"
    tx_fec1: str = "none"
    tx_subcarrier_alloc: Optional[tuple] = None
    payload_len: int = 256

    rx_freq: float = 460.0e6
    rx_rate: float = 500e3
    rx_gain: float = 0.0
    rx_subcarriers: int = 32
    rx_cp_len: int = 16
    rx_taper_len: int = 4
    rx_subcarrier_alloc: Optional[tuple] = None


class Radio:
    def __init__(
        self,
        medium_rate: float,
        medium_center: float,
        node_id: int = 0,
        log_sink=None,
        *,
        device: torch.device | str = "cuda",
    ):
        # where the tx chain and the receiver run: the card unless the caller
        # asks for the CPU; with no card the default raises here
        self.device = require_device(device)
        self.params = RadioParams()
        self.medium_rate = medium_rate
        self.medium_center = medium_center
        self.node_id = node_id
        self.log_sink = log_sink

        # worker states (include/extensible_cognitive_radio.hpp:44-50)
        self.tx_state = TX_STOPPED
        self.rx_running = False
        self.ce_running = False
        self.ce_timeout_ms = 1000.0
        self.ce_sensing = False
        self.ce_usrp_rx_buffer_length = 512
        self.CE_metrics = CEMetrics()

        self.frame_num = 0
        self.tx_header_control = np.zeros(6, np.uint8)  # control info bytes
        self.stats = RxStatistics()
        self.rx_stat_fb_period_s: float | None = None

        self._tx_queue: deque[np.ndarray] = deque()
        self._ctrl_queue: deque[np.ndarray] = deque()
        self._tx_residual = np.zeros(0, np.complex64)
        self._tx_sample_cursor = 0  # phase-continuous mixing
        self._rx_sample_cursor = 0
        self._rx_resid_sens = np.zeros(0, np.complex64)
        self._gen: OFDMFrameGen | None = None
        self._rx: StreamReceiver | None = None
        self._rx_dirty = True
        # deque, not list: the pipelined node loop's tx-producer thread may
        # push TX_COMPLETE/underrun events while the CE drains (the
        # reference has the same tx-worker/CE-thread concurrency,
        # src/extensible_cognitive_radio.cpp:1643-1758) — deque append and
        # popleft are individually atomic under the GIL
        self._events: deque[CEMetrics] = deque()
        # live per-frame metrics console (print_metrics,
        # src/extensible_cognitive_radio.cpp:1814-1842), enabled by the
        # node config's print_rx_frame_metrics flag
        self.print_rx_frame_metrics = False
        # organic UHD_UNDERRUN producer: fire when a continuous tx stream
        # runs dry mid-burst (the USRP 'U' condition); opt-in because extra
        # CE events change timing-sensitive engine schedules
        self.underrun_detect = False
        self._was_streaming = False
        self.rx_packet_sink: deque[tuple[int, np.ndarray]] = deque()  # the "TUN"
        self.num_tx_frames = 0
        # rx squelch (liquid agc/squelch analog): skip frame detection on
        # blocks at the tracked noise floor; ratio is linear POWER margin.
        # Two stages: a raw-medium gate (cheap, catches an empty medium)
        # and an IN-BAND gate on the decimated baseband (catches the busy-
        # medium case where every transmitter is out of this rx's band —
        # the common case in multi-pair scenarios, where the raw gate
        # never fires because SOMEONE is always transmitting)
        self.rx_squelch_enabled = True
        self.rx_squelch_ratio = 1.35  # ~1.3 dB above the floor
        # in-band gate: decode-referenced — squelch blocks more than
        # `ib_margin` (power ratio) below the learned level of blocks that
        # actually decoded frames.  Liquid's squelch is likewise an absolute
        # threshold referenced to AGC signal levels, not a noise-floor
        # ratio: adjacent-channel OFDM sidelobes sit far above thermal but
        # far below frames, and only a signal-referenced threshold splits
        # them.  Probing re-opens the gate: every `ib_probe` consecutive
        # squelched blocks one is processed anyway, and the reference
        # decays, so a link whose partner turns its gain down is re-acquired.
        self.rx_squelch_ib_margin = 0.1  # 10 dB below decoded-frame level
        self.rx_squelch_ib_probe = 16
        # rx frame-scan batching (NodeConfig.rx_scan_blocks): accumulate N
        # hot baseband blocks and scan once — frames span ~2 blocks at the
        # default rates, so per-block scanning rescans the straddle
        # residual every time; batched, each sample is scanned ~once.
        # N=1 (default) is exact per-block behavior; cold blocks flush.
        self.rx_scan_accumulate = 1
        self._rx_acc: list[np.ndarray] = []
        self._rx_acc_pw: list[float] = []
        self._rx_noise_floor: float | None = None
        self._rx_blocks_seen = 0
        self._rx_hot_prev = True
        self._ib_signal_ref: float | None = None
        self._ib_squelch_run = 0
        # receiver-referred thermal noise (see runtime/medium.py): set from
        # MediumConfig.noise_power by build_node; 0 = noiseless front end
        self.rx_noise_power = 0.0
        self.noise_seed: object = node_id
        self._noise_rng: np.random.Generator | None = None

    # ------------------------------------------------------------------
    # parameter API (ECR setter/getter surface)
    # ------------------------------------------------------------------

    def _set(self, name: str, value, side: str) -> None:
        setattr(self.params, name, value)
        if side == "rx":
            self._rx_dirty = True
        # tx-side rebuilds need no dirty flag: _get_gen's config-keyed cache
        # IS the recreate_fg semantics (a changed config misses the cache and
        # builds a fresh generator at the next frame)

    # tx
    def set_tx_freq(self, f: float) -> None:
        self._set("tx_freq", float(f), "tx")

    def set_tx_rate(self, r: float) -> None:
        self._set("tx_rate", float(r), "tx")

    def set_tx_gain(self, g: float) -> None:
        self._set("tx_gain", float(g), "tx")

    def set_tx_gain_soft(self, g: float) -> None:
        self._set("tx_gain_soft", float(g), "tx")

    def set_tx_modulation(self, m: str) -> None:
        self._set("tx_modulation", m, "tx")

    def set_tx_crc(self, c: str) -> None:
        self._set("tx_crc", c, "tx")

    def set_tx_fec0(self, f: str) -> None:
        self._set("tx_fec0", f, "tx")

    def set_tx_fec1(self, f: str) -> None:
        self._set("tx_fec1", f, "tx")

    def set_tx_subcarriers(self, n: int) -> None:
        self._set("tx_subcarriers", int(n), "tx")

    def set_tx_subcarrier_alloc(self, alloc) -> None:
        self._set("tx_subcarrier_alloc", None if alloc is None else tuple(alloc), "tx")

    def set_tx_cp_len(self, n: int) -> None:
        self._set("tx_cp_len", int(n), "tx")

    def set_tx_taper_len(self, n: int) -> None:
        self._set("tx_taper_len", int(n), "tx")

    def set_tx_payload_sym_length(self, n: int) -> None:
        self._set("payload_len", int(n), "tx")

    def get_tx_freq(self) -> float:
        return self.params.tx_freq

    def get_tx_rate(self) -> float:
        return self.params.tx_rate

    def get_tx_gain(self) -> float:
        return self.params.tx_gain

    def get_tx_gain_soft(self) -> float:
        return self.params.tx_gain_soft

    def get_tx_modulation(self) -> str:
        return self.params.tx_modulation

    def get_tx_crc(self) -> str:
        return self.params.tx_crc

    def get_tx_fec0(self) -> str:
        return self.params.tx_fec0

    def get_tx_fec1(self) -> str:
        return self.params.tx_fec1

    def get_tx_state(self) -> int:
        return self.tx_state

    # rx
    def set_rx_freq(self, f: float) -> None:
        self._set("rx_freq", float(f), "rx")

    def set_rx_rate(self, r: float) -> None:
        self._set("rx_rate", float(r), "rx")

    def set_rx_gain(self, g: float) -> None:
        self._set("rx_gain", float(g), "rx")

    def set_rx_subcarriers(self, n: int) -> None:
        self._set("rx_subcarriers", int(n), "rx")

    def set_rx_subcarrier_alloc(self, alloc) -> None:
        self._set("rx_subcarrier_alloc", None if alloc is None else tuple(alloc), "rx")

    def set_rx_cp_len(self, n: int) -> None:
        self._set("rx_cp_len", int(n), "rx")

    def set_rx_taper_len(self, n: int) -> None:
        self._set("rx_taper_len", int(n), "rx")

    def get_rx_freq(self) -> float:
        return self.params.rx_freq

    def get_rx_rate(self) -> float:
        return self.params.rx_rate

    def get_rx_gain(self) -> float:
        return self.params.rx_gain

    # worker control
    def start_tx(self) -> None:
        self.tx_state = TX_CONTINUOUS

    def stop_tx(self) -> None:
        self.tx_state = TX_STOPPED

    def start_rx(self) -> None:
        self.rx_running = True

    def stop_rx(self) -> None:
        self.rx_running = False

    def start_ce(self) -> None:
        self.ce_running = True

    def stop_ce(self) -> None:
        self.ce_running = False

    def set_ce_timeout_ms(self, t: float) -> None:
        self.ce_timeout_ms = float(t)

    def set_ce_sensing(self, flag: int) -> None:
        self.ce_sensing = bool(flag)

    def set_ce_usrp_rx_buffer_length(self, n: int) -> None:
        self.ce_usrp_rx_buffer_length = int(n)

    def set_control_info(self, info: np.ndarray) -> None:
        self.tx_header_control = np.asarray(info, np.uint8)[:6]

    def reset_rx_stats(self) -> None:
        self.stats.reset()

    def get_rx_stats(self, now: float):
        return self.stats.snapshot(now)

    # ------------------------------------------------------------------
    # data path
    # ------------------------------------------------------------------

    def enqueue_packet(self, payload: np.ndarray) -> None:
        """Network-layer packet for transmission (the TUN write side)."""
        self._tx_queue.append(np.asarray(payload, np.uint8))

    def transmit_control_frame(self, payload: np.ndarray) -> None:
        """CE-initiated control frame (include/extensible_cognitive_radio.hpp
        transmit_control_frame); sent ahead of data packets."""
        self._ctrl_queue.append(np.asarray(payload, np.uint8))

    def _tx_cfg(self) -> OFDMFrameConfig:
        p = self.params
        return OFDMFrameConfig(
            num_subcarriers=p.tx_subcarriers,
            cp_len=p.tx_cp_len,
            taper_len=p.tx_taper_len,
            mod_scheme=p.tx_modulation,
            crc_scheme=p.tx_crc,
            fec0=p.tx_fec0,
            fec1=p.tx_fec1,
            subcarrier_alloc=p.tx_subcarrier_alloc,
        )

    def _rx_cfg(self) -> OFDMFrameConfig:
        p = self.params
        return OFDMFrameConfig(
            num_subcarriers=p.rx_subcarriers,
            cp_len=p.rx_cp_len,
            taper_len=p.rx_taper_len,
            subcarrier_alloc=p.rx_subcarrier_alloc,
        )

    def _get_gen(self, payload_len: int) -> OFDMFrameGen:
        # process-wide cache: all identically-configured radios share one
        # generator (and its device tables) — see framegen.gen_for
        return gen_for(self._tx_cfg(), payload_len)

    def _make_frame_samples(self, frame_type: int, payload: np.ndarray) -> np.ndarray:
        """One frame at medium rate/offset with gains applied (the
        transmit_frame path, src/extensible_cognitive_radio.cpp:883-949)."""
        return self._make_frames_batch([frame_type], [payload])[0]

    def _make_frames_batch(self, frame_types, payloads) -> np.ndarray:
        """N same-length frames at medium rate with gains applied — ONE
        batched assemble dispatch for the whole run of queued packets
        (transmit_frame, src/extensible_cognitive_radio.cpp:883-949; each
        frame is resampled independently, so the result is sample-identical
        to N single-frame calls placed back to back)."""
        f = len(payloads)
        gen = self._get_gen(len(payloads[0]))
        headers = np.zeros((f, 8), np.uint8)
        nums = self.frame_num + np.arange(f)
        headers[:, 0] = ((nums >> 8) & 0x3F).astype(np.uint8) | (
            np.asarray(frame_types, np.uint8) << 6
        )
        headers[:, 1] = (nums & 0xFF).astype(np.uint8)
        headers[:, 2:8] = self.tx_header_control
        self.frame_num += f
        g = _soft_gain_f(self.params.tx_gain_soft) * _soft_gain_f(
            self.params.tx_gain
        )
        up, down = _rate_ratio(self.medium_rate, self.params.tx_rate)
        # assemble -> gain -> polyphase resample to the medium rate on the
        # radio's device, all in float32 planes, then ONE copy to the host
        # (each frame is its own row, so no batch padding is needed: the
        # reference padded to a power of two for its jit cache)
        chain = _tx_chain_fn_for(gen.cfg, gen.payload_len, up, down, self.device)
        pl_ = chain(
            gen.encode_header_batch(headers),
            gen.encode_payload_batch(np.stack(payloads)),
            np.float32(g),
        )
        iq = np.empty(pl_.shape[:2], np.complex64)
        iq.real = pl_[..., 0]
        iq.imag = pl_[..., 1]
        if self.log_sink is not None:
            for k in range(f):
                self.log_sink.log_phy_tx(
                    self.node_id,
                    self.frame_num - f + k,
                    dataclasses.asdict(self.params),
                )
        return iq

    def _frame_len_medium(self, payload_len: int) -> int:
        """Samples one frame occupies at the medium rate."""
        gen = self._get_gen(payload_len)
        up, down = _rate_ratio(self.medium_rate, self.params.tx_rate)
        return -(-gen.frame_len * up // down)

    def pull_tx_block(self, n: int) -> np.ndarray | None:
        """Medium-facing: produce this node's next n transmit samples at the
        medium rate (None = silent)."""
        out = np.zeros(n, np.complex64)
        filled = 0
        emitted = False
        # drain residual first
        if len(self._tx_residual):
            k = min(n, len(self._tx_residual))
            out[:k] = self._tx_residual[:k]
            self._tx_residual = self._tx_residual[k:]
            filled = k
            emitted = True
        while filled < n:
            # pop the whole run of same-length packets this block can carry
            # (control frames first, matching the per-frame priority), then
            # assemble the run with ONE batched dispatch
            batch_types: list[int] = []
            batch_payloads: list[np.ndarray] = []
            est = 0
            while est < n - filled:
                if self._ctrl_queue:
                    src, frame_type = self._ctrl_queue, FrameType.CONTROL
                elif self.tx_state == TX_CONTINUOUS and self._tx_queue:
                    src, frame_type = self._tx_queue, FrameType.DATA
                else:
                    break
                payload = src[0]
                if batch_payloads and len(payload) != len(batch_payloads[0]):
                    break  # next run (different frame length) next iteration
                src.popleft()
                batch_types.append(frame_type)
                batch_payloads.append(payload)
                est += self._frame_len_medium(len(payload))
            if not batch_payloads:
                break
            frames = self._make_frames_batch(batch_types, batch_payloads)
            self.num_tx_frames += len(batch_payloads)
            samples = frames.reshape(-1)
            k = min(n - filled, len(samples))
            out[filled : filled + k] = samples[:k]
            self._tx_residual = np.concatenate([self._tx_residual, samples[k:]])
            filled += k
            emitted = True
            if not self._tx_queue and not self._ctrl_queue and not len(self._tx_residual):
                self._push_event(CEEvent.TX_COMPLETE)
        if self.underrun_detect and self.tx_state == TX_CONTINUOUS:
            if filled < n and (emitted or self._was_streaming):
                # stream went dry mid-burst: the UHD underrun analog
                # (uhd_msg_handler 'U', src/extensible_cognitive_radio.cpp:1326-1347)
                self.notify_underrun(self._tx_sample_cursor / self.medium_rate)
                self._was_streaming = False
            elif filled == n:
                self._was_streaming = True
        if not emitted:
            self._tx_sample_cursor += n
            return None
        # mix to the tx center offset, phase-continuous across blocks
        off = (self.params.tx_freq - self.medium_center) / self.medium_rate
        out = _mix(out, off, self._tx_sample_cursor)
        self._tx_sample_cursor += n
        return out

    # -- rx --

    def _apply_rx_params(self) -> None:
        # the candidate budget must scale with the scan-batch size, or an
        # N-block buffer still returns only a 1-block budget of frames
        # (silent loss on dense streams)
        self._rx = StreamReceiver(
            self._rx_cfg(),
            max_frames_per_block=16 * max(int(self.rx_scan_accumulate), 1),
            device=self.device,
        )
        self._rx_dirty = False
        self._rx_resid_sens = np.zeros(0, np.complex64)
        # a retune changes what "in band" means: relearn the reference;
        # accumulated pre-retune samples are dropped (the reference's
        # synchronizer likewise loses sync across a retune)
        self._ib_signal_ref = None
        self._ib_squelch_run = 0
        self._rx_acc = []
        self._rx_acc_pw = []

    def _noise_slice(self, n: int) -> np.ndarray:
        """Receiver thermal noise: ``n`` complex samples at rx_noise_power.

        Served from a process-wide pre-drawn unit-Gaussian pool at offsets
        from this radio's own seeded rng — per-sample draws cost more than
        the rest of the rx front end at 13 MS/s, and per-radio pools would
        be 32 MB x 48 nodes."""
        pool = _noise_pool()
        if self._noise_rng is None:
            self._noise_rng = np.random.default_rng(self.noise_seed)
        scale = np.float32(np.sqrt(self.rx_noise_power / 2))
        out = np.empty(n, np.complex64)
        filled = 0
        while filled < n:  # n can exceed the pool in pathological configs
            k = min(n - filled, len(pool) - 1)
            o = int(self._noise_rng.integers(0, len(pool) - k))
            np.multiply(pool[o : o + k], scale, out=out[filled : filled + k])
            filled += k
        return out

    def _deliver_sensing(self, base: np.ndarray, t: float) -> None:
        """Sensing tap (src/extensible_cognitive_radio.cpp:1310-1324):
        forward raw rx-rate samples to the CE in fixed-size buffers."""
        buf = np.concatenate([self._rx_resid_sens, base])
        blen = self.ce_usrp_rx_buffer_length
        k = len(buf) // blen
        for i in range(k):
            chunk = buf[i * blen : (i + 1) * blen]
            ev = CEMetrics(ce_event=CEEvent.USRP_RX_SAMPS, time_s=t)
            ev.payload = chunk  # ce_usrp_rx_buffer
            self._events.append(ev)
        self._rx_resid_sens = buf[k * blen :]

    def push_rx_block(
        self, block: np.ndarray | None, t: float, n: int | None = None
    ) -> None:
        """Medium-facing: deliver a received SIGNAL block (medium rate) at
        sim time t.  ``block=None`` means no transmitter was heard (pass
        ``n`` = block length); receiver thermal noise (``rx_noise_power``,
        receiver-referred — see runtime/medium.py) is added here."""
        if not self.rx_running and not self.ce_sensing:
            return
        if self._rx_dirty or self._rx is None:
            self._apply_rx_params()
        if block is not None:
            n = len(block)
        elif n is None:
            raise ValueError("push_rx_block(None) needs the block length n")

        # squelch (liquid's AGC squelch inside ofdmflexframesync,
        # driven per-sample in ECR_rx_worker src/extensible_cognitive_radio
        # .cpp:1299-1324): track the noise floor as the minimum block power
        # and skip frame DETECTION on blocks at the floor (the sensing tap,
        # like liquid's AGC, still sees every sample).  Mean power is
        # mixing/resampling-invariant, so it is measured on the raw signal
        # plus the known thermal power — the noise samples themselves are
        # only ever synthesized for blocks that get processed.  A block
        # following an above-floor block is always processed so a frame
        # tail straddling a hot->cold boundary still decodes.
        sp = (
            0.0
            if block is None
            else float(np.vdot(block, block).real) / max(n, 1)
        )
        bp = sp + self.rx_noise_power
        nf = self._rx_noise_floor
        nf = bp if nf is None else min(nf * 1.0005, bp) if bp < nf else nf * 1.0005
        self._rx_noise_floor = nf
        self._rx_blocks_seen += 1
        hot = bp > self.rx_squelch_ratio * nf + 1e-20
        # the raw gate only skips GENUINELY silent blocks (no transmitter
        # heard this step): a power-relative raw gate squelched in-band
        # frames whenever a loud stable out-of-band carrier pinned the
        # total power near the floor — level discrimination within the rx
        # band is the in-band gate's job (below), measured after
        # decimation where out-of-band energy is gone
        squelch = (
            self.rx_squelch_enabled
            and self._rx_blocks_seen > 4
            and block is None
            and not self._rx_hot_prev
        )
        self._rx_hot_prev = hot
        if squelch and not self.ce_sensing:
            self._rx_sample_cursor += n
            if self.rx_running and self._rx is not None:
                self._flush_rx_acc(t)  # skip() discards the residual
                up, down = _rate_ratio(self.params.rx_rate, self.medium_rate)
                self._rx.skip(-(-n * up // down))
            return

        # receiver front-end noise
        if self.rx_noise_power > 0.0:
            noise = self._noise_slice(n)
            block = noise if block is None else block + noise
        elif block is None:
            block = np.zeros(n, np.complex64)

        # mix down from the rx center offset and decimate to rx_rate
        off = (self.params.rx_freq - self.medium_center) / self.medium_rate
        base = _mix(block, -off, self._rx_sample_cursor)
        self._rx_sample_cursor += n
        up, down = _rate_ratio(self.params.rx_rate, self.medium_rate)
        if (up, down) != (1, 1):
            base = resample_poly(base, up, down).astype(np.complex64)
        if squelch:  # sensing-only delivery: frame detection stays skipped
            if self.ce_sensing:
                self._deliver_sensing(base, t)
            if self.rx_running and self._rx is not None:
                self._flush_rx_acc(t)
                self._rx.skip(len(base))
            return

        # sensing tap (src/extensible_cognitive_radio.cpp:1310-1324): forward
        # raw samples to the CE in fixed-size buffers
        if self.ce_sensing:
            self._deliver_sensing(base, t)

        if not self.rx_running:
            return

        # in-band squelch (decode-referenced, see __init__): skip the frame
        # scan on blocks whose decimated-baseband power sits > ib_margin
        # below the learned decoded-frame level.  A squelched block is
        # CARRIED, not dropped: its prefix-sized tail stays in the
        # receiver's residual, so a frame starting in the last samples of a
        # cold block still decodes whole in the next (hot) block.
        ibp = float(np.vdot(base, base).real) / max(len(base), 1) + 1e-30
        if self.rx_squelch_enabled and self._ib_signal_ref is not None:
            ib_hot = ibp >= self._ib_signal_ref * self.rx_squelch_ib_margin
            probe = (
                not ib_hot
                and self._ib_squelch_run + 1 >= self.rx_squelch_ib_probe
            )
            # a cold block is squelched unless the receiver holds a
            # detected-but-incomplete frame (its tail may be arriving in
            # this very block, power notwithstanding) or it is a probe
            if not ib_hot and not self._rx.pending_frame and not probe:
                self._ib_squelch_run += 1
                self._ib_signal_ref *= 0.998  # re-acquire a quieter link
                self._flush_rx_acc(t)  # carry() expects stream order
                self._rx.carry(base)
                return
            self._ib_squelch_run = 0
        if self.rx_scan_accumulate > 1:
            # hot-block scan batching (rx_scan_blocks, see __init__)
            self._rx_acc.append(base)
            self._rx_acc_pw.append(ibp)
            if len(self._rx_acc) < self.rx_scan_accumulate:
                return
            base = np.concatenate(self._rx_acc)
            ibp = float(np.mean(self._rx_acc_pw))
            self._rx_acc = []
            self._rx_acc_pw = []
        self._process_rx_buffer(base, ibp, t)

    def flush_rx_scan(self, t: float) -> None:
        """Public end-of-stream flush: scan whatever hot blocks the
        rx_scan_accumulate batcher still holds (the node runtimes call
        this at shutdown so batched scanning never loses tail frames)."""
        if self.rx_running and self._rx is not None:
            self._flush_rx_acc(t)

    def _flush_rx_acc(self, t: float) -> None:
        """Scan any accumulated hot blocks NOW (a cold block, squelch skip,
        or retune ends the batch)."""
        if not self._rx_acc:
            return
        base = (
            self._rx_acc[0]
            if len(self._rx_acc) == 1
            else np.concatenate(self._rx_acc)
        )
        ibp = float(np.mean(self._rx_acc_pw))
        self._rx_acc = []
        self._rx_acc_pw = []
        self._process_rx_buffer(base, ibp, t)

    def _process_rx_buffer(self, base: np.ndarray, ibp: float, t: float) -> None:
        """Frame-scan a baseband buffer and deliver its frames (events,
        stats, packet sink, logs, squelch-reference learning)."""
        decoded_any = False
        for f in self._rx.process(base):
            s = f["stats"]
            hdr = f["header"]
            frame_type = (int(hdr[0]) >> 6) & 0x3
            frame_n = ((int(hdr[0]) & 0x3F) << 8) | int(hdr[1])
            m = CEMetrics(
                ce_event=CEEvent.PHY_FRAME_RECEIVED,
                frame_type=frame_type,
                frame_num=frame_n,
                control_info=np.asarray(hdr[2:8], np.uint8),
                header=hdr,
                header_valid=s.header_valid,
                payload=f["payload"],
                payload_valid=s.payload_valid,
                stats=s,
                time_s=t,
            )
            self._events.append(m)
            if self.print_rx_frame_metrics:
                _print_metrics(m)
            self.stats.record_frame(
                t, s.payload_valid, s.evm, s.rssi, f["payload"]
            )
            if self.log_sink is not None:
                self.log_sink.log_phy_rx(self.node_id, m)
            if frame_type == FrameType.DATA and s.payload_valid:
                # the TUN write (src/extensible_cognitive_radio.cpp:1441-1450)
                self.rx_packet_sink.append((frame_n, f["payload"]))
            decoded_any = decoded_any or s.header_valid
        if decoded_any:
            # learn the in-band level of frame-bearing blocks (EWMA) — the
            # squelch reference; see __init__.  Downward moves are capped
            # hard: a decode at level L proves frames live at L, so the
            # reference may never sit more than 6 dB above the latest
            # decode level — after a legitimate >10 dB partner power drop,
            # the FIRST successful probe re-opens the gate instead of
            # ~20 EWMA steps of every-16th-block probing
            r = self._ib_signal_ref
            r = ibp if r is None else 0.9 * r + 0.1 * ibp
            self._ib_signal_ref = min(r, 4.0 * ibp)

    def _push_event(self, event: CEEvent, t: float = 0.0) -> None:
        self._events.append(CEMetrics(ce_event=event, time_s=t))

    def notify_overflow(self, t: float) -> None:
        """UHD overflow surfaced as a CE event (uhd_msg_handler path,
        src/extensible_cognitive_radio.cpp:1326-1347)."""
        self.stats.record_overflow()
        self._push_event(CEEvent.UHD_OVERFLOW, t)

    def notify_underrun(self, t: float) -> None:
        self._push_event(CEEvent.UHD_UNDERRUN, t)

    def drain_events(self) -> list[CEMetrics]:
        # popleft until empty (no swap): an event appended concurrently by
        # the tx producer is either drained now or survives for next time —
        # never lost to a stale-list race
        ev: list[CEMetrics] = []
        while True:
            try:
                ev.append(self._events.popleft())
            except IndexError:
                return ev


def _print_metrics(m: CEMetrics) -> None:
    """Live per-frame metrics table (print_metrics,
    src/extensible_cognitive_radio.cpp:1814-1842 layout)."""
    s = m.stats
    print("\n---------------------------------------------------------")
    print(f"Received Frame {m.frame_num} metrics:      Received Frame Parameters:")
    print("---------------------------------------------------------")
    print(f"Header Valid:     {int(m.header_valid):<6}      "
          f"Modulation Scheme:   {s.mod_scheme}")
    print(f"Payload Valid:    {int(m.payload_valid):<6}      "
          f"Modulation bits/sym: {s.mod_bps}")
    print(f"EVM:              {s.evm:<8.2f}    Check:               {s.check}")
    print(f"RSSI:             {s.rssi:<8.2f}    Inner FEC:           {s.fec0}")
    print(f"Frequency Offset: {s.cfo:<8.4f}    Outer FEC:           {s.fec1}")


def _rate_ratio(target: float, source: float, max_den: int = 4096) -> tuple[int, int]:
    """Integer up/down for source -> target rate.

    Exact: config rates are rational multiples of each other (all reference
    scenario rates are, e.g. 1.4e6 -> 13e6 is 65/7); if the exact ratio needs
    a denominator beyond ``max_den`` this RAISES instead of silently
    resampling to a slightly wrong rate."""
    from fractions import Fraction

    exact = Fraction(target) / Fraction(source)  # floats are exact rationals
    fr = exact.limit_denominator(max_den)
    if fr != exact and abs(fr - exact) / exact > 1e-9:
        raise ValueError(
            f"rate ratio {target}/{source} is not a rational multiple with "
            f"denominator <= {max_den}; pick rates with an exact ratio"
        )
    return fr.numerator, fr.denominator
