"""Structured run logging + binary spill + Octave export.

Replaces the reference's raw-struct binary logs and offline converter
(src/extensible_cognitive_radio.cpp:1844-1864,
src/convert_logs_bin_to_octave.cpp): five record streams — PHY_RX, PHY_TX,
INT_TX, NET_RX, NET_TX (:103-230) — collected in memory, exportable to
compressed ``.npz`` and to Octave ``.m`` assignment files with the same
variable naming style the converter emits, so the reference's Octave
post-processing workflow still applies.

The reference can also stream records to packed-binary ``.crnl`` files
through its native CRC-framed binlog engine (``spill_dir``,
``read_binlog``); ``BINLOG_SCHEMAS`` keeps their record layouts.  That
engine's loader is not ported yet, so here those two raise
``NotImplementedError``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np

__all__ = ["LogSink", "BINLOG_SCHEMAS", "read_binlog", "read_binlog_dir"]


# Per-stream packed layouts: (field, struct code) pairs; 8s/12s are
# NUL-padded ASCII. The full format string is stored in the .crnl header
# ("<stream>:<fmt>"), so readers never depend on this table matching the
# writer's version.
BINLOG_SCHEMAS: dict[str, list[tuple[str, str]]] = {
    "phy_rx": [
        ("node", "B"),
        ("t", "d"),
        ("frame_num", "I"),
        ("frame_type", "B"),
        ("header_valid", "B"),
        ("payload_valid", "B"),
        ("evm_dB", "f"),
        ("rssi_dB", "f"),
        ("cfo", "f"),
        ("num_framesyms", "I"),
        ("mod_scheme", "12s"),
        ("crc", "12s"),
        ("fec0", "12s"),
        ("fec1", "12s"),
    ],
    "phy_tx": [
        ("node", "B"),
        ("frame_num", "I"),
        ("tx_freq", "d"),
        ("tx_rate", "d"),
        ("tx_gain", "f"),
        ("tx_gain_soft", "f"),
        ("tx_subcarriers", "I"),
        ("tx_cp_len", "I"),
        ("tx_taper_len", "I"),
        ("tx_modulation", "12s"),
        ("tx_crc", "12s"),
        ("tx_fec0", "12s"),
        ("tx_fec1", "12s"),
    ],
    "net_tx": [("node", "B"), ("t", "d"), ("packet_num", "I"), ("bytes", "I")],
    "net_rx": [("node", "B"), ("t", "d"), ("packet_num", "I"), ("bytes", "I")],
    "int_tx": [("node", "B"), ("t", "d"), ("tx_freq", "d")],
}


_NATIVE_MISSING = (
    "binary .crnl logs need the native binlog engine, and the port's loader "
    "for native/ is not written yet (ROADMAP Queue 1: the native/ loader); "
    "use the in-memory sink, save_npz or export_octave"
)


def read_binlog(path: str | Path) -> tuple[str, list[dict]]:
    """Parse one .crnl stream file -> (stream_name, records).  Needs the
    native binlog engine, not ported yet: raises NotImplementedError."""
    raise NotImplementedError(_NATIVE_MISSING)


def read_binlog_dir(path: str | Path) -> dict[str, list[dict]]:
    raise NotImplementedError(_NATIVE_MISSING)


class LogSink:
    def __init__(
        self,
        flags: dict[str, bool] | None = None,
        spill_dir: str | Path | None = None,
    ):
        self.flags = flags or {}
        self.phy_rx: list[dict[str, Any]] = []
        self.phy_tx: list[dict[str, Any]] = []
        self.net_rx: list[dict[str, Any]] = []
        self.net_tx: list[dict[str, Any]] = []
        self.int_tx: list[dict[str, Any]] = []
        if spill_dir is not None:
            raise NotImplementedError(_NATIVE_MISSING)

    def _on(self, key: str) -> bool:
        return self.flags.get(key, True)

    def close(self) -> None:
        """Nothing to close: the port's sink holds its records in memory
        (the reference's also streams them to .crnl files with a spill_dir)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- record streams (convert_logs_bin_to_octave.cpp:103-230) --

    def log_phy_rx(self, node: int, metrics) -> None:
        if not self._on("log_phy_rx"):
            return
        s = metrics.stats
        self.phy_rx.append(
            {
                "node": node,
                "t": metrics.time_s,
                "frame_num": metrics.frame_num,
                "frame_type": int(metrics.frame_type),
                "header_valid": bool(metrics.header_valid),
                "payload_valid": bool(metrics.payload_valid),
                "evm_dB": s.evm if s else 0.0,
                "rssi_dB": s.rssi if s else 0.0,
                "cfo": s.cfo if s else 0.0,
                "num_framesyms": s.num_framesyms if s else 0,
                "mod_scheme": s.mod_scheme if s else "",
                "crc": s.check if s else "",
                "fec0": s.fec0 if s else "",
                "fec1": s.fec1 if s else "",
            }
        )

    def log_phy_tx(self, node: int, frame_num: int, params: dict) -> None:
        if not self._on("log_phy_tx"):
            return
        rec = {"node": node, "frame_num": frame_num}
        rec.update(
            {
                k: params[k]
                for k in (
                    "tx_freq",
                    "tx_rate",
                    "tx_gain",
                    "tx_gain_soft",
                    "tx_subcarriers",
                    "tx_cp_len",
                    "tx_taper_len",
                    "tx_modulation",
                    "tx_crc",
                    "tx_fec0",
                    "tx_fec1",
                )
                if k in params
            }
        )
        self.phy_tx.append(rec)

    def log_net_tx(self, node: int, t: float, packet: np.ndarray) -> None:
        if not self._on("log_net_tx"):
            return
        from cognitive_radio_network_tpu_torch.runtime.traffic import TrafficSource

        self.net_tx.append(
            {
                "node": node,
                "t": t,
                "packet_num": TrafficSource.packet_number(packet),
                "bytes": len(packet),
            }
        )

    def log_net_rx(self, node: int, t: float, packet: np.ndarray) -> None:
        if not self._on("log_net_rx"):
            return
        from cognitive_radio_network_tpu_torch.runtime.traffic import TrafficSource

        self.net_rx.append(
            {
                "node": node,
                "t": t,
                "packet_num": TrafficSource.packet_number(packet),
                "bytes": len(packet),
            }
        )

    def log_int_tx(self, node: int, t: float, freq: float) -> None:
        if not self._on("log_int_tx"):
            return
        self.int_tx.append({"node": node, "t": t, "tx_freq": freq})

    # -- export --

    def _columns(self, records: list[dict]) -> dict[str, np.ndarray]:
        if not records:
            return {}
        keys = records[0].keys()
        return {k: np.array([r.get(k) for r in records]) for k in keys}

    def save_npz(self, path: str | Path) -> None:
        arrays = {}
        for name in ("phy_rx", "phy_tx", "net_rx", "net_tx", "int_tx"):
            for k, v in self._columns(getattr(self, name)).items():
                arrays[f"{name}.{k}"] = v
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(path, **arrays)

    def export_octave(self, path: str | Path) -> None:
        """Octave .m assignments in the converter's style
        (convert_logs_bin_to_octave.cpp emits e.g. phy_rx_t(i) = ...)."""
        lines = []
        for name in ("phy_rx", "phy_tx", "net_rx", "net_tx", "int_tx"):
            cols = self._columns(getattr(self, name))
            for k, v in cols.items():
                var = f"{name}_{k}"
                if v.dtype.kind in "OU":  # strings -> cell array
                    cells = ", ".join(f"'{x}'" for x in v)
                    lines.append(f"{var} = {{{cells}}};")
                else:
                    vals = ", ".join(
                        str(int(x)) if float(x).is_integer() else repr(float(x))
                        for x in v.astype(float)
                    )
                    lines.append(f"{var} = [{vals}];")
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text("\n".join(lines) + "\n")
