"""Device-resident streaming receive: the port's device API over the configuration's links.

Each receive stream of the configuration (``links``) gets the cyclic tape of
``drivers/rx_stream.py`` (the same seed gives the same tapes), kept on the
card as float32 planes and extended by one block, cyclically, so that every
block is a slice of it.  The traffic's ``mix`` says how the streams are fed:

* ``batch``: one ``StreamBank`` of all the streams; a block of every stream
  (``block_samples`` each) goes in one ``feed`` call, one device step;
* ``round_robin``: one ``StreamReceiver`` a stream on ``feed_device``, served
  round robin, a block of ``block_samples`` a call.

The receivers are built as the radio runtime builds them (the receiver's
OFDM geometry) with the traffic's ``max_frames_per_block``, and copy their
step records to the host ``fetch_group`` steps at a time.  The loop is
closed: a call returns once its step is dispatched, the receiver keeps at
most ``max_lag`` steps in flight and hands back the frames of older ones,
and the next block goes in when the call returns.  The harness cuts each
block from the tapes (for a batch, one copy on the card into contiguous
planes) outside the program's calls.  Before the clock starts, each
receiver is given ``max_lag`` blocks, so the window opens as it closes, with
``max_lag`` steps in flight a receiver.  ``rx_frames_per_s`` is every frame
delivered intact within the window over its wall time; a delivery is kept as
plain data (no object the garbage collector walks) and held to the tape once
the clock has stopped.

Due, late and missing frames are those of ``drivers/rx_stream.py``, whose
comparison this driver shares: once the window has closed, the steps still
in flight are drained (their frames are late), then each stream is fed on,
untimed, until its due frames have come out (or two frames and a block
later).  ``control`` puts the reference, computed in bfloat16, in the
program's place for the soft values.

In the traced window the harness notes the offsets and lengths of the
extract gathers each stream step launches (by wrapping the module
attributes the step calls), for ``extract_roofline.step``.
"""

from __future__ import annotations

import contextlib
import time
import types

import numpy as np
import torch

from crn_bench.drivers import rx_stream
from crn_bench.reference.link import make_tape


class Driver(rx_stream.Driver):
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, spans, control=False):
        super().__init__(config, traffic, seed, device, spans, control=control)
        self.block = int(traffic["block_samples"])
        self.batch = traffic["mix"] == "batch"
        if traffic["mix"] not in ("batch", "round_robin"):
            raise ValueError(f"unknown mix {traffic['mix']!r}")
        self.max_lag = int(traffic["max_lag"])

    def setup(self) -> None:
        from cognitive_radio_network_tpu_torch.phy.framegen import OFDMFrameConfig
        from cognitive_radio_network_tpu_torch.phy.stream import StreamReceiver

        if self.batch:
            try:
                from cognitive_radio_network_tpu_torch.phy.stream import StreamBank
            except ImportError as e:
                raise RuntimeError("the batch mix feeds every stream in one device step, and this "
                                   "port has no StreamBank") from e
        rng = np.random.default_rng([self.seed, 3])
        rx = self.config["receiver"]
        self.tapes = [make_tape(link, self.config["medium"], int(self.traffic["min_tape_samples"]), rng)
                      for link in self.config["links"]]
        lengths = {len(t.samples) for t in self.tapes}
        if self.batch and len(lengths) != 1:
            raise ValueError(f"a batch steps its streams together; tape lengths {sorted(lengths)}")
        ext = np.stack([np.resize(t.samples, len(t.samples) + self.block) for t in self.tapes])
        self.planes = (torch.from_numpy(np.ascontiguousarray(ext.real)).to(self.device),
                       torch.from_numpy(np.ascontiguousarray(ext.imag)).to(self.device))
        del ext
        geometry = OFDMFrameConfig(num_subcarriers=rx["num_subcarriers"], cp_len=rx["cp_len"],
                                   taper_len=rx["taper_len"])
        frames = int(self.traffic["max_frames_per_block"])
        if self.batch:
            self.bank = StreamBank(geometry, len(self.tapes), frames, device=self.device)
            self.bank.fetch_group = int(self.traffic["fetch_group"])
        else:
            self.receivers = [StreamReceiver(geometry, max_frames_per_block=frames, device=self.device)
                              for _ in self.tapes]
            for r in self.receivers:
                r.fetch_group = int(self.traffic["fetch_group"])
        self.fed = [0] * len(self.tapes)
        want = int(self.traffic["warmup_frames"])
        got = [0] * len(self.tapes)
        for s, tape in enumerate(self.tapes):  # until each stream has delivered its first frames
            limit = (want + 3) * (len(tape.samples) // len(tape.starts)) + 2 * self.block
            while got[s] < want and self.fed[s] < limit:
                for j, fr in self._step(s, self.max_lag):
                    got[j] += len(fr)
        self._flush()

    # ---------------------------------------------------------------- feeding

    def _step(self, s: int, lag: int) -> list:
        """One call into the program: a block of stream ``s`` (of every stream
        in a batch).  Returns [(stream, frames)] of what the call handed back."""
        re, im = self.planes
        pos = self.fed[s] % len(self.tapes[s].samples)
        if self.batch:
            br, bi = re[:, pos : pos + self.block].contiguous(), im[:, pos : pos + self.block].contiguous()
            with self.spans("feed"):
                out = self.bank.feed(br, bi, max_lag=lag)
            self.fed = [f + self.block for f in self.fed]
            return list(enumerate(out))
        br, bi = re[s, pos : pos + self.block], im[s, pos : pos + self.block]
        with self.spans("feed"):
            out = self.receivers[s].feed_device(br, bi, max_lag=lag)
        self.fed[s] += self.block
        return [(s, out)]

    def _flush(self) -> list:
        if self.batch:
            return list(enumerate(self.bank.flush()))
        return [(s, r.flush()) for s, r in enumerate(self.receivers)]

    @contextlib.contextmanager
    def _noting_gathers(self, notes: list):
        """Note (offsets, planes' length, window lengths) of each extract
        gather launched inside a stream step, while the block runs."""
        from cognitive_radio_network_tpu_torch.phy import framesync, stream

        inside = [0]  # stream steps open
        orig = stream._stream_step_graph, framesync.extract_windows, stream.extract_window_sets

        def step(*a, **kw):
            inside[0] += 1
            try:
                return orig[0](*a, **kw)
            finally:
                inside[0] -= 1

        def one(rr, ri, offsets, wlen, **kw):
            if inside[0]:
                notes.append((offsets, rr.shape[0], (int(wlen),)))
            return orig[1](rr, ri, offsets, wlen, **kw)

        def sets(rr, ri, offsets, wlens, **kw):
            if inside[0]:
                notes.append((offsets, rr.shape[0], tuple(map(int, wlens))))
            return orig[2](rr, ri, offsets, wlens, **kw)

        stream._stream_step_graph, framesync.extract_windows, stream.extract_window_sets = step, one, sets
        try:
            yield
        finally:
            stream._stream_step_graph, framesync.extract_windows, stream.extract_window_sets = orig

    # ---------------------------------------------------------------- window

    @staticmethod
    def _kept(s: int, f: dict) -> tuple:
        """A delivery as a tuple of numbers and arrays: once the collector has
        seen it, it drops out of the collector's walks, which would otherwise
        grow with every frame the window keeps."""
        st = f["stats"]
        return (s, int(f["offset"]), np.array(f["header"]), np.array(f["payload"]),
                bool(st.header_valid), bool(st.payload_valid), float(st.cfo), float(st.rssi),
                float(st.evm))

    @staticmethod
    def _delivery(kept: tuple) -> tuple:
        s, offset, header, payload, hv, pv, cfo, rssi, evm = kept
        stats = types.SimpleNamespace(header_valid=hv, payload_valid=pv, cfo=cfo, rssi=rssi, evm=evm)
        return s, {"offset": offset, "stats": stats, "header": header, "payload": payload}

    def window(self, seconds: float) -> dict:
        streams = len(self.tapes)
        self.start_fed = list(self.fed)
        kept = []
        gathers: list = []
        calls = 0
        noting = self._noting_gathers(gathers) if self.spans.profiled else contextlib.nullcontext()
        with noting:
            fill = self.max_lag * (1 if self.batch else streams)
            for c in range(fill):  # max_lag steps in flight a receiver, as at the close
                kept += [self._kept(s, f) for s, frames in self._step(c % streams, self.max_lag)
                         for f in frames]
            early = len(kept)  # none while max_lag or fewer steps are in flight
            t0 = time.perf_counter()
            t_end = t0 + seconds
            per_second = [0] * (int(seconds) + 1)
            while (now := time.perf_counter()) < t_end:
                per_second[int(now - t0)] += 1
                for s, frames in self._step(calls % streams, self.max_lag):
                    for f in frames:
                        kept.append(self._kept(s, f))
                calls += 1
            wall = time.perf_counter() - t0
        self.delivered = [self._delivery(k) for k in kept]  # (stream, frame dict)
        del kept
        intact = sum(self._intact(s, f) for s, f in self.delivered[early:])
        self.counters = {"calls": calls, "streams": streams, "batch": self.batch,
                         "extract_gathers": [(o.cpu().numpy(), n, w) for o, n, w in gathers]}
        late = self._drain()
        due = sum(len(self._due(s)) for s in range(streams))
        return {"metrics": {"rx_frames_per_s": intact / wall},
                "attempted": due,
                "notes": [f"{'feed' if self.batch else 'feed_device'} calls {calls} in {wall!r} s over "
                          f"{streams} streams ({fill} before the clock); frames due {due}, delivered "
                          f"{len(self.delivered)} ({late} "
                          f"after the window), intact in the window {intact}; calls begun in each second "
                          f"{per_second}"]}

    def _drain(self) -> int:
        """Drain the steps in flight, then feed each stream on past the
        window's close until its due frames have come out, keeping those
        deliveries and no others.  Returns the deliveries after the window."""
        self.close_fed = list(self.fed)
        before = len(self.delivered)
        self.delivered += [(s, f) for s, frames in self._flush() for f in frames]
        due = [self._due(s) for s in range(len(self.tapes))]
        got = [set() for _ in self.tapes]
        for s, f in self.delivered:
            got[s].add(int(f["offset"]))
        for s, tape in enumerate(self.tapes):
            until = self.fed[s] + 2 * tape.layout.frame_len + self.block
            while self.fed[s] < until and not due[s] <= got[s]:
                for k, frames in self._step(s, 0):
                    for f in frames:
                        if int(f["offset"]) in due[k] - got[k]:
                            self.delivered.append((k, f))
                            got[k].add(int(f["offset"]))
        return len(self.delivered) - before

    def release(self) -> None:
        if self.batch:
            del self.bank
        else:
            del self.receivers
        del self.planes
