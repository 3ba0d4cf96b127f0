"""Streaming receive: ``StreamReceiver.process`` over the configuration's links.

Each receive stream of the configuration (``links``) gets a cyclic tape made
from the seed (``reference/link.py``: CRTS-paced frames of the link's PHY,
the transmitter's gains, receiver noise) and a ``StreamReceiver`` built as
the radio runtime builds it (``runtime/radio.py``: the receiver's OFDM
geometry, ``16 * rx_scan_blocks`` candidates a block).  The streams are
served round robin, one host block of ``block_samples`` at a time (the
medium's block at the receiver's rate times ``rx_scan_blocks``; a block that
runs past the tape's end continues at its start), each block once the
previous call has returned (a closed-loop replay).
``rx_frames_per_s`` is every frame delivered intact (header and payload
bytes equal to those sent, CRC passed) over the window's wall time.

Every frame whose last sample was fed in the window is due.  Once the
window has closed, each stream is fed on, untimed, until its due frames have
come out (or two frames and a block later): a frame that comes then is late,
not wrong, and does not count in the rate.  A due frame that never came, a
delivery that is not a sent frame at its true offset, or one whose bytes or
flags are wrong counts as failed.  Each delivery's soft
values (CFO, RSSI, EVM) are compared with those the plain reference works
out from the tape at the frame's true start.  ``control`` puts the
reference, computed in bfloat16, in the program's place for the soft values.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from crn_bench.reference.link import make_tape
from crn_bench.reference.phy import soft_values


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, spans, control=False):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.spans, self.control = spans, control
        self.block = int(config["receiver"]["block_samples"])
        self.counters = {}

    def setup(self) -> None:
        from cognitive_radio_network_tpu_torch.phy.framegen import OFDMFrameConfig
        from cognitive_radio_network_tpu_torch.phy.stream import StreamReceiver

        rng = np.random.default_rng([self.seed, 3])
        rx = self.config["receiver"]
        min_samples = int(self.traffic["min_tape_samples"])
        self.tapes = [make_tape(link, self.config["medium"], min_samples, rng)
                      for link in self.config["links"]]
        geometry = OFDMFrameConfig(num_subcarriers=rx["num_subcarriers"], cp_len=rx["cp_len"],
                                   taper_len=rx["taper_len"])
        self.receivers = [StreamReceiver(geometry, max_frames_per_block=16 * int(rx["rx_scan_blocks"]),
                                         device=self.device) for _ in self.tapes]
        self.fed = [0] * len(self.tapes)  # samples fed to each receiver
        want = int(self.traffic["warmup_frames"])
        for s, tape in enumerate(self.tapes):  # until each receiver has delivered its first frames
            got, limit = 0, (want + 3) * (len(tape.samples) // len(tape.starts)) + self.block
            while got < want and self.fed[s] < limit:
                got += len(self._feed(s))

    def _feed(self, s: int, span: bool = True) -> list:
        tape = self.tapes[s].samples
        pos = self.fed[s] % len(tape)
        end = pos + self.block
        block = tape[pos:end] if end <= len(tape) else np.concatenate((tape[pos:], tape[: end - len(tape)]))
        with self.spans("process") if span else contextlib.nullcontext():
            frames = self.receivers[s].process(block)
        self.fed[s] += self.block
        return frames

    def window(self, seconds: float) -> dict:
        import cognitive_radio_network_tpu_torch.phy.fec as fec
        from crn_bench.harness import wrapped

        streams = len(self.tapes)
        self.start_fed = list(self.fed)
        self.delivered = []  # (stream, frame dict)
        calls = intact = 0
        with wrapped(fec, "decode_bits", self.spans, "decode_bits") if self.spans.on else contextlib.nullcontext():
            t0 = time.perf_counter()
            t_end = t0 + seconds
            per_second = [0] * (int(seconds) + 1)
            while (now := time.perf_counter()) < t_end:
                per_second[int(now - t0)] += 1
                s = calls % streams
                for f in self._feed(s):
                    self.delivered.append((s, f))
                    intact += self._intact(s, f)
                calls += 1
            wall = time.perf_counter() - t0
        self.counters = {"process_calls": calls}
        self._drain()
        due = sum(len(self._due(s)) for s in range(streams))
        return {"metrics": {"rx_frames_per_s": intact / wall},
                "attempted": due,
                "notes": [f"process calls {calls} in {wall!r} s over {streams} streams; frames due "
                          f"{due}, delivered {len(self.delivered)}, intact {intact}; calls begun in "
                          f"each second {per_second}"]}

    def _drain(self) -> None:
        """Feed each stream on past the window's close until its due frames
        have come out, keeping their deliveries and no others."""
        self.close_fed = list(self.fed)
        for s, tape in enumerate(self.tapes):
            due = self._due(s)
            got = {int(f["offset"]) for k, f in self.delivered if k == s}
            until = self.fed[s] + 2 * tape.layout.frame_len + self.block
            while self.fed[s] < until and not due <= got:
                for f in self._feed(s, span=False):
                    if int(f["offset"]) in due:
                        self.delivered.append((s, f))
                        got.add(int(f["offset"]))

    def _frame_at(self, s: int, offset: int):
        tape = self.tapes[s]
        hit = np.flatnonzero(tape.starts == offset % len(tape.samples))
        return int(hit[0]) if len(hit) else None

    def _intact(self, s: int, f: dict) -> bool:
        tape = self.tapes[s]
        j = self._frame_at(s, int(f["offset"]))
        st = f["stats"]
        return (j is not None and st.header_valid and st.payload_valid
                and np.array_equal(np.asarray(f["header"]), tape.headers[j])
                and np.array_equal(np.asarray(f["payload"]), tape.payloads[j]))

    def _due(self, s: int) -> set[int]:
        """Absolute starts of stream s's frames whose last sample was fed in
        the window and whose first was fed to the receiver at all."""
        tape = self.tapes[s]
        n, flen = len(tape.samples), tape.layout.frame_len
        lo, hi = self.start_fed[s], self.close_fed[s]
        out = set()
        for start in tape.starts:
            first = start + n * ((lo - flen - start) // n)
            for a in range(first, hi, n):
                if a >= 0 and lo < a + flen <= hi:  # whole, and fed since the receiver began
                    out.add(int(a))
        return out

    def release(self) -> None:
        del self.receivers

    def check(self):
        limits = self.traffic["limits"]
        wrong = missing = 0
        gaps = {"evm_gap_db": 0.0, "rssi_gap_db": 0.0, "cfo_gap": 0.0}
        for s, tape in enumerate(self.tapes):
            got = [f for k, f in self.delivered if k == s]
            due = self._due(s)
            offsets = [int(f["offset"]) for f in got]
            missing += len(due - set(offsets))
            wrong += sum(1 for f in got if not self._intact(s, f) or int(f["offset"]) not in due)
            wrong += len(offsets) - len(set(offsets))
            js = sorted({j for f in got if (j := self._frame_at(s, int(f["offset"]))) is not None})
            if not js:
                continue
            frames = np.stack([tape.frame(j) for j in js])
            ref = dict(zip(js, soft_values(tape.layout, frames)))
            if self.control:
                ctrl = dict(zip(js, soft_values(tape.layout, frames, dtype=torch.bfloat16)))
            for f in got:
                j = self._frame_at(s, int(f["offset"]))
                if j is None:
                    continue
                st = f["stats"]
                mine = ctrl[j] if self.control else (st.cfo, st.rssi, st.evm)
                for k, (a, b) in zip(("cfo_gap", "rssi_gap_db", "evm_gap_db"), zip(mine, ref[j])):
                    gaps[k] = max(gaps[k], abs(float(a) - float(b)))
        self.info = {k: v for k, v in gaps.items() if k not in limits}
        checks = {k: (v, float(limits[k])) for k, v in gaps.items() if k in limits}
        checks["frames_wrong"] = (float(wrong), 0.0)
        checks["frames_missing"] = (float(missing), 0.0)
        return checks, wrong + missing + (not self.delivered)
