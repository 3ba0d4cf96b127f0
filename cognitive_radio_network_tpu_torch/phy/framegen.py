"""OFDM frame generator — the ``ofdmflexframegen`` capability.

Port of ``cognitive_radio_network_tpu/phy/framegen.py``.  Frame format
(time domain), for M subcarriers / CP-length C:

    [ S0 | S0 | S1+CP | header symbols... | payload symbols... ]

* **S0** (x2): short sync symbol — QPSK PRBS on every 2nd active subcarrier,
  giving half-symbol time periodicity for Schmidl&Cox-style detection and
  coarse CFO estimation (replaces liquid's S0 plan).
* **S1**: full known QPSK PRBS symbol (with CP) for one-shot channel
  estimation (replaces liquid's S1/long sequence).
* **header**: 8 user bytes (the reference packs frame number + type + 6
  control-info bytes here, src/extensible_cognitive_radio.cpp:893-896) plus a
  6-byte internal PHY header [payload_len:2 | mod | fec0 | fec1 | crc] so the
  receiver adapts per frame + CRC-32, Hamming(12,8) FEC, BPSK — a fixed
  robust scheme, like liquid's internal header coding.
* **payload**: bytes + CRC + fec0 + fec1 (outer), modulated at the
  configured scheme.  Defaults mirror the ECR defaults: 32 subcarriers,
  cp 16, taper 4, QAM4, CRC-32, Hamming(12,8)+none
  (src/extensible_cognitive_radio.cpp:52-56, :100-104).

Data/pilot symbols carry per-symbol BPSK PRBS pilots for common-phase
tracking.  A raised-cosine taper of ``taper_len`` samples rises over the
head of each cyclic prefix (liquid's tapered windowing).

The preambles, pilots, sizing and the CRC/FEC bit plumbing are the
reference's numpy code, copied, so every constant is identical.  Modulation
and the IFFT run batched in PyTorch on the requested device.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from cognitive_radio_network_tpu_torch.phy import crc as crc_mod
from cognitive_radio_network_tpu_torch.phy import fec as fec_mod
from cognitive_radio_network_tpu_torch.phy import modem, subcarriers
from cognitive_radio_network_tpu_torch.phy.bits import unpack_bits
from cognitive_radio_network_tpu_torch.signal.msequence import MSequence

__all__ = [
    "OFDMFrameConfig",
    "OFDMFrameGen",
    "gen_for",
    "pack_phy_header",
    "unpack_phy_header",
    "pilot_sequence",
]

HEADER_BYTES = 8  # user header bytes (ECR frame num/type + control info)
PHY_HEADER_BYTES = 6  # internal: payload_len(2, LE) | mod | fec0 | fec1 | crc
TOTAL_HEADER_BYTES = HEADER_BYTES + PHY_HEADER_BYTES
_HEADER_CRC = "crc32"
_HEADER_FEC = "h128"
_HEADER_MOD = "bpsk"


def pack_phy_header(cfg: "OFDMFrameConfig", payload_len: int) -> np.ndarray:
    return np.array(
        [
            payload_len & 0xFF,
            (payload_len >> 8) & 0xFF,
            modem.SCHEMES.index(cfg.mod_scheme),
            fec_mod.SCHEMES.index(cfg.fec0),
            fec_mod.SCHEMES.index(cfg.fec1),
            crc_mod.SCHEMES.index(cfg.crc_scheme),
        ],
        np.uint8,
    )


def unpack_phy_header(phy: np.ndarray):
    """-> (payload_len, mod, fec0, fec1, crc) or None if ids out of range."""
    payload_len = int(phy[0]) | (int(phy[1]) << 8)
    try:
        return (
            payload_len,
            modem.SCHEMES[int(phy[2])],
            fec_mod.SCHEMES[int(phy[3])],
            fec_mod.SCHEMES[int(phy[4])],
            crc_mod.SCHEMES[int(phy[5])],
        )
    except IndexError:
        return None


@dataclasses.dataclass(frozen=True)
class OFDMFrameConfig:
    num_subcarriers: int = 32
    cp_len: int = 16
    taper_len: int = 4
    mod_scheme: str = "qam4"
    crc_scheme: str = "crc32"
    fec0: str = "h128"
    fec1: str = "none"
    subcarrier_alloc: tuple[int, ...] | None = None  # None -> default_alloc

    def alloc(self) -> np.ndarray:
        if self.subcarrier_alloc is not None:
            return np.asarray(self.subcarrier_alloc, np.uint8)
        return subcarriers.default_alloc(self.num_subcarriers)

    @property
    def symbol_len(self) -> int:
        return self.num_subcarriers + self.cp_len


def _prbs_qpsk(n: int, seed: int) -> np.ndarray:
    ms = MSequence(m=11, init=seed)
    re = np.array([2 * ms.advance() - 1 for _ in range(n)], np.float32)
    im = np.array([2 * ms.advance() - 1 for _ in range(n)], np.float32)
    return ((re + 1j * im) / np.sqrt(2)).astype(np.complex64)


def _prbs_bpsk(n: int, seed: int) -> np.ndarray:
    ms = MSequence(m=11, init=seed)
    return np.array([2 * ms.advance() - 1 for _ in range(n)], np.float32).astype(
        np.complex64
    )


@functools.lru_cache(maxsize=32)
def pilot_sequence(num_symbols: int, n_pilots: int) -> np.ndarray:
    """Deterministic per-(symbol, pilot) BPSK sequence shared by gen and sync."""
    return _prbs_bpsk(num_symbols * max(n_pilots, 1), seed=0x2AA).reshape(
        num_symbols, -1
    )


def _taper_window(taper_len: int, device: torch.device) -> torch.Tensor:
    """float32 sin^2 ramp over ``taper_len`` samples, computed in float32."""
    n = torch.arange(taper_len, dtype=torch.float32, device=device) + 0.5
    return torch.sin(0.5 * np.pi * n / taper_len) ** 2


class OFDMFrameGen:
    """Stateless batched frame assembler for a fixed config + payload length."""

    def __init__(self, cfg: OFDMFrameConfig, payload_len: int):
        self.cfg = cfg
        self.payload_len = payload_len
        m = cfg.num_subcarriers
        alloc = cfg.alloc()
        self.alloc = alloc
        self.data_idx = np.flatnonzero(alloc == subcarriers.SC_DATA)
        self.pilot_idx = np.flatnonzero(alloc == subcarriers.SC_PILOT)
        self.active_idx = np.flatnonzero(alloc != subcarriers.SC_NULL)
        if len(self.data_idx) == 0:
            raise ValueError("allocation has no data subcarriers")

        # --- preamble construction (frequency domain, unshifted) ---
        s0 = np.zeros(m, np.complex64)
        # S0 occupies only EVEN subcarrier indices so its time-domain signal
        # is periodic with period M/2 — the property the Schmidl&Cox
        # autocorrelation detector relies on.
        s0_act = self.active_idx[self.active_idx % 2 == 0]
        # sqrt(2) boost keeps S0 at the same time-domain power with half the
        # occupied bins.
        s0[s0_act] = _prbs_qpsk(len(s0_act), seed=0x5A5 & 0x7FF) * np.sqrt(2)
        self.S0_freq = s0
        s1 = np.zeros(m, np.complex64)
        s1[self.active_idx] = _prbs_qpsk(len(self.active_idx), seed=0x3C3)
        self.S1_freq = s1

        self.S0_time = np.fft.ifft(s0) * np.sqrt(m)  # no CP, periodic by design
        s1_time = np.fft.ifft(s1) * np.sqrt(m)
        self.S1_time = np.concatenate([s1_time[-cfg.cp_len :], s1_time])

        # --- sizing ---
        hdr_enc_bytes = fec_mod.encoded_length(
            _HEADER_FEC, TOTAL_HEADER_BYTES + crc_mod.crc_sizes(_HEADER_CRC)
        )
        self.n_header_bits = hdr_enc_bytes * 8
        self.n_header_syms = -(-self.n_header_bits // len(self.data_idx))

        enc0 = fec_mod.encoded_length(
            cfg.fec0, payload_len + crc_mod.crc_sizes(cfg.crc_scheme)
        )
        self.payload_enc_bytes = fec_mod.encoded_length(cfg.fec1, enc0)
        bps = modem.bits_per_symbol(cfg.mod_scheme)
        total_mod_syms = -(-self.payload_enc_bytes * 8 // bps)
        self.n_payload_syms = -(-total_mod_syms // len(self.data_idx))
        self.bps = bps

        self.num_symbols = self.n_header_syms + self.n_payload_syms
        self.frame_len = (
            2 * m  # two S0 symbols, no CP
            + (m + cfg.cp_len)  # S1
            + self.num_symbols * (m + cfg.cp_len)
        )
        # per-symbol pilot PRBS (BPSK), fixed across frames
        self.pilots = pilot_sequence(self.num_symbols, len(self.pilot_idx))
        self._on_device: dict[torch.device, dict[str, torch.Tensor]] = {}

    # ----- host-side bit plumbing -----

    def encode_header(self, header: np.ndarray) -> np.ndarray:
        """8 user header bytes -> coded bits (n_header_bits,), with the
        internal PHY header (payload_len/mod/fec/crc of this generator)
        appended before coding."""
        header = np.asarray(header, np.uint8)
        if header.shape != (HEADER_BYTES,):
            raise ValueError(f"header must be {HEADER_BYTES} bytes")
        full = np.concatenate([header, pack_phy_header(self.cfg, self.payload_len)])
        with_crc = np.concatenate([full, crc_mod.crc_generate(_HEADER_CRC, full)])
        return unpack_bits(fec_mod.encode(_HEADER_FEC, with_crc))

    def encode_payload(self, payload: np.ndarray) -> np.ndarray:
        """payload bytes -> coded bits (payload_enc_bytes*8,)."""
        payload = np.asarray(payload, np.uint8)
        if payload.shape != (self.payload_len,):
            raise ValueError(f"payload must be {self.payload_len} bytes")
        with_crc = np.concatenate(
            [payload, crc_mod.crc_generate(self.cfg.crc_scheme, payload)]
        )
        return unpack_bits(fec_mod.encode(self.cfg.fec1, fec_mod.encode(self.cfg.fec0, with_crc)))

    def encode_header_batch(self, headers: np.ndarray) -> np.ndarray:
        """Batched encode_header: (B, 8) -> coded bits (B, n_header_bits)."""
        headers = np.asarray(headers, np.uint8)
        phy = pack_phy_header(self.cfg, self.payload_len)
        full = np.concatenate(
            [headers, np.tile(phy, (headers.shape[0], 1))], axis=1
        )
        with_crc = np.concatenate(
            [full, crc_mod.crc_generate_batch(_HEADER_CRC, full)], axis=1
        )
        return np.unpackbits(
            fec_mod.encode_batch(_HEADER_FEC, with_crc), axis=-1
        )

    def encode_payload_batch(self, payloads: np.ndarray) -> np.ndarray:
        """Batched encode_payload: (B, P) -> coded bits (B, n_bits)."""
        payloads = np.asarray(payloads, np.uint8)
        with_crc = np.concatenate(
            [payloads, crc_mod.crc_generate_batch(self.cfg.crc_scheme, payloads)],
            axis=1,
        )
        return np.unpackbits(
            fec_mod.encode_batch(
                self.cfg.fec1, fec_mod.encode_batch(self.cfg.fec0, with_crc)
            ),
            axis=-1,
        )

    # ----- device-side synthesis -----

    def device_constants(self, device: torch.device | str) -> dict[str, torch.Tensor]:
        """The generator's tables on ``device``, built once per device: the
        index maps, pilots, S1, the preamble, the CP window, the 2x-S0
        detection template and this generator's 6-byte PHY header."""
        device = torch.device(device)
        if device not in self._on_device:
            cfg = self.cfg
            m, cp = cfg.num_subcarriers, cfg.cp_len

            def t(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(device)

            self._on_device[device] = {
                "data_idx": t(self.data_idx),
                "pilot_idx": t(self.pilot_idx),
                "active_idx": t(self.active_idx),
                "pilots": t(self.pilots),
                "s1_freq": t(self.S1_freq),
                "preamble": t(np.concatenate([self.S0_time, self.S0_time, self.S1_time])
                              .astype(np.complex64)),
                "tmpl": t(np.concatenate([self.S0_time, self.S0_time]).astype(np.complex64)),
                "phy": t(pack_phy_header(cfg, self.payload_len)),
                "window": torch.cat([
                    _taper_window(cfg.taper_len, device),
                    torch.ones(m + cp - cfg.taper_len, device=device),
                ]),
            }
        return self._on_device[device]

    def assemble(
        self,
        headers: np.ndarray,
        payloads: np.ndarray,
        *,
        as_planes: bool = False,
        device: torch.device | str = "cuda",
    ) -> torch.Tensor:
        """Batched frames: headers (B, 8), payloads (B, P) -> IQ (B, frame_len).

        Returns complex64 (B, frame_len) or float32 planes (B, frame_len, 2),
        on ``device``: the card unless the caller asks for the CPU (with no
        card the default raises).  CRC/FEC coding runs on the host;
        modulation, the IFFT, the cyclic prefix and the taper run on
        ``device``.
        """
        headers = np.atleast_2d(np.asarray(headers, np.uint8))
        payloads = np.atleast_2d(np.asarray(payloads, np.uint8))
        return self.assemble_bits(
            self.encode_header_batch(headers),
            self.encode_payload_batch(payloads),
            as_planes=as_planes,
            device=device,
        )

    def assemble_bits(
        self,
        hdr_bits: np.ndarray,
        pay_bits: np.ndarray,
        *,
        as_planes: bool = False,
        device: torch.device | str = "cuda",
    ) -> torch.Tensor:
        """:meth:`assemble` from coded bits: ``hdr_bits`` (B, n_header_bits)
        and ``pay_bits`` (B, payload_enc_bytes*8) as ``encode_header_batch``
        and ``encode_payload_batch`` give them (host arrays, copied to
        ``device`` once each)."""
        device = torch.device(device)
        hdr_bits = torch.as_tensor(hdr_bits).to(device)
        pay_bits = torch.as_tensor(pay_bits).to(device)
        cfg = self.cfg
        m, cp = cfg.num_subcarriers, cfg.cp_len
        nd = len(self.data_idx)
        c = self.device_constants(device)
        bdim = hdr_bits.shape[0]

        # header: BPSK bits -> symbols padded to fill header OFDM symbols
        hpad = self.n_header_syms * nd - hdr_bits.shape[1]
        hsyms = torch.nn.functional.pad(hdr_bits.to(torch.int64), (0, hpad))
        hpoints = modem.modulate(_HEADER_MOD, hsyms)

        # payload: group bits into mod symbols
        ppad_bits = self.n_payload_syms * nd * self.bps - pay_bits.shape[1]
        bits = torch.nn.functional.pad(pay_bits.to(torch.int64), (0, ppad_bits))
        weights = 1 << torch.arange(self.bps - 1, -1, -1, dtype=torch.int64, device=device)
        psyms = (bits.reshape(bdim, -1, self.bps) * weights).sum(dim=-1)
        ppoints = modem.modulate(cfg.mod_scheme, psyms)

        points = torch.cat(
            [
                hpoints.reshape(bdim, self.n_header_syms, nd),
                ppoints.reshape(bdim, self.n_payload_syms, nd),
            ],
            dim=1,
        )  # (B, num_symbols, nd)

        # frequency-domain grid
        x = torch.zeros((bdim, self.num_symbols, m), dtype=torch.complex64, device=device)
        x[:, :, c["data_idx"]] = points
        if len(self.pilot_idx):
            x[:, :, c["pilot_idx"]] = c["pilots"].expand(bdim, *self.pilots.shape)
        t = torch.fft.ifft(x, dim=-1) * np.float32(np.sqrt(m))
        with_cp = torch.cat([t[..., -cp:], t], dim=-1)
        if cfg.taper_len > 0:
            # Rising ramp over the head of the CP only: smooths symbol
            # transitions for spectral containment while leaving every
            # useful sample untouched (the receiver discards the CP, so
            # this is demod-transparent as long as channel delay spread
            # stays under cp_len - taper_len).
            with_cp = with_cp * c["window"]
        body = with_cp.reshape(bdim, -1)
        pre = c["preamble"]
        iq = torch.cat([pre.expand(bdim, pre.shape[0]), body], dim=-1)
        if as_planes:
            return torch.stack([iq.real, iq.imag], dim=-1).float()
        return iq


@functools.lru_cache(maxsize=512)
def gen_for(cfg: OFDMFrameConfig, payload_len: int) -> OFDMFrameGen:
    """Process-wide OFDMFrameGen cache: identically-configured radios share
    one generator (and its device constants).  OFDMFrameGen is stateless, so
    sharing is safe."""
    return OFDMFrameGen(cfg, payload_len)
