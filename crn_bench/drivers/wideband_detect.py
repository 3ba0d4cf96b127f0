"""Wideband detection: back-to-back continuous ``make_wideband_fn`` calls on device-resident captures.

A monitor server channelizes ``fleet`` continuous captures into 64 channels
and decides each channel's occupancy every sense cycle.  Each call hands the
program the next ``cycles`` cycles of every stream, taken in turn from a
ring of ``ring`` consecutive blocks that the benchmark synthesized on the
card from the seed (together larger than the card's L2 cache); the tape is
cyclic, block 0 following the last block.  The program carries each
stream's filter state from call to call (``continuous=True``).  Each call's
decisions and noise floors are copied to pinned host memory and read by the
client, which takes each stream's occupancy map at the end of every sensing
period (every ``report_cycles`` cycles: what a monitor reports) and counts
its occupied channels; at most ``in_flight`` calls are outstanding.  ``detect_msps`` is every wide
sample whose decisions reached the host, over the window's wall time.

The set-up runs every block once, so the window's first call continues from
the last block's tail and every call of a block sees the same samples and
the same history.  Every decision of every call is held to the first call
of its block on the card: the harness adds each later call's decisions (0
or 1) into a sum of its block, outside the program's span, and at the
window's end a cell whose sum is not the block's later calls times its first
decision counts as failed (a sum of 0 or 1 terms reaches 0 or their number
only when every term agrees).  The client holds each call's counts and its
noise floors (every cycle, as bytes) to the first call's on the host: a call
that differs counts as failed.  After
the window, each block's first call has its decisions compared with the
reference where the reference's energy lies clear of the threshold by the
margin; a reservoir sample of calls drawn from the seed is compared whole
(energy, noise, decisions) with the reference, its decisions against the
threshold applied to its own energies, and its decisions and noise as bytes
against the first call of its block.  ``control`` feeds the program the
planes rounded to bfloat16 while the reference reads the float32 planes.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from crn_bench.reference.wideband import make_capture, pu_centers, wideband_reference


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, spans, control=False):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.spans, self.control = spans, control
        wb = config["wideband"]
        self.streams = int(config["fleet"])
        self.cycles = int(traffic["cycles"])
        self.rows = self.cycles * wb["block_len"]
        self.report = min(int(traffic["report_cycles"]), self.cycles)  # cycles a sensing period
        self.samples = self.streams * self.rows * wb["num_channels"]  # wide samples a call
        self.counters = {"streams": self.streams, "rows": self.rows, "block_len": wb["block_len"],
                         "channels": wb["num_channels"], "taps": wb["taps_per_channel"]}

    def setup(self) -> None:
        from cognitive_radio_network_tpu_torch.parallel.wideband import WidebandConfig, make_wideband_fn

        wb = self.config["wideband"]
        cfg = WidebandConfig(num_channels=wb["num_channels"], taps_per_channel=wb["taps_per_channel"],
                             block_len=wb["block_len"], threshold_ratio=wb["threshold_ratio"])
        self.fn = make_wideband_fn(cfg, continuous=True, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        centers = pu_centers(gen, self.config)
        self.ring = [make_capture(gen, self.streams, self.cycles, self.config, centers)
                     for _ in range(int(self.traffic["ring"]))]
        self.inputs = [p.bfloat16().float() for p in self.ring] if self.control else self.ring
        pin = self.device != "cpu"
        self.slots = [(torch.empty(self.streams, self.cycles, wb["num_channels"], dtype=torch.bool,
                                   pin_memory=pin),
                       torch.empty(self.streams, self.cycles, 1, dtype=torch.float32, pin_memory=pin),
                       torch.cuda.Event() if pin else None)
                      for _ in range(int(self.traffic["in_flight"]))]
        for planes in self.inputs:  # every block once, as the window runs them
            res = self.fn(planes)
            self.slots[0][0].copy_(res["occupied"])
            self.slots[0][1].copy_(res["noise"])
        self.position = 0  # the ring's block the next call takes

    def _read(self, entry) -> None:
        """The client reads a call's decisions once they are on the host: it
        counts each stream's occupied channels at the end of every sensing
        period and holds the counts and the noise floors (as bytes) to those
        of the first call of the block (and keeps that first call whole)."""
        r, (occ, noise, done) = entry
        if done is not None:
            done.synchronize()
        o, n = occ.numpy(), noise.numpy()
        counts = np.count_nonzero(o[:, self.report - 1 :: self.report], axis=-1)
        if r not in self.first:
            self.first[r] = (o.copy(), n.copy(), counts, n.tobytes())
        first = self.first[r]
        self.repeats += not np.array_equal(counts, first[2]) or n.tobytes() != first[3]
        self.read += 1

    def window(self, seconds: float) -> dict:
        fn, spans, inputs, slots = self.fn, self.spans, self.inputs, self.slots
        keep = int(self.traffic["kept_calls"])
        draw = np.random.default_rng([self.seed, 1]).random(1 << 20)  # the reservoir's draws
        self.first, self.kept, self.read, self.repeats = {}, [], 0, 0
        # per block on the card: its first call's decisions, the sum of its
        # later calls' decisions and their number
        first_dev, sums, later = {}, {}, collections.Counter()
        inflight = collections.deque()
        i = 0  # calls issued in this window; the ring's position goes on from the last window
        t0 = time.perf_counter()
        t_end = t0 + seconds
        per_second = [0] * (int(seconds) + 1)
        while (now := time.perf_counter()) < t_end:
            per_second[int(now - t0)] += 1
            if len(inflight) == len(slots):
                with spans("client_read"):
                    self._read(inflight.popleft())
            r = self.position
            self.position = (r + 1) % len(inputs)
            with spans("wideband_call"):
                res = fn(inputs[r])
            slot = slots[i % len(slots)]
            with spans("copy_back"):
                slot[0].copy_(res["occupied"], non_blocking=True)
                slot[1].copy_(res["noise"], non_blocking=True)
                if slot[2] is not None:
                    slot[2].record()
            with spans("repeat_check"):
                if r in first_dev:
                    sums[r].add_(res["occupied"])
                    later[r] += 1
                else:
                    first_dev[r] = res["occupied"]
                    sums[r] = torch.zeros(res["occupied"].shape, dtype=torch.int32, device=self.device)
            if i < keep:  # reservoir sample of whole calls
                self.kept.append((r, res))
            elif (j := int(draw[i % len(draw)] * (i + 1))) < keep:
                self.kept[j] = (r, res)
            inflight.append((r, slot))
            i += 1
        while inflight:
            with spans("client_read"):
                self._read(inflight.popleft())
        wall = time.perf_counter() - t0
        for r, first in first_dev.items():  # cells some later call of the block decided otherwise
            self.repeats += int((sums[r] != later[r] * first.int()).sum())
        read = self.read
        return {"metrics": {"detect_msps": read * self.samples / wall / 1e6},
                "attempted": read,
                "notes": [f"calls read {read} in {wall!r} s; calls issued in each second {per_second}"]}

    def release(self) -> None:
        del self.fn, self.slots
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def check(self):
        wb, limits = self.config["wideband"], self.traffic["limits"]
        ratio, margin = wb["threshold_ratio"], limits["decision_margin"]
        gaps = {"energy_gap": 0.0, "noise_gap": 0.0}
        repeat_mismatch = self.repeats
        decision_mismatch = 0
        for r, res in self.kept:  # the sample, as bytes, against its block's first call
            occ, noise = self.first[r][:2]
            repeat_mismatch += not (np.array_equal(res["occupied"].cpu().numpy(), occ)
                                    and np.array_equal(res["noise"].cpu().numpy(), noise))
        n_ring = len(self.ring)
        for r, planes in enumerate(self.ring):
            if r not in self.first:
                continue
            ref = wideband_reference(planes, self.ring[(r - 1) % n_ring], wb)
            thr = ratio * ref["noise"]
            clear = (ref["energy"] - thr).abs() > margin * thr
            occ = torch.as_tensor(self.first[r][0]).to(clear.device)
            decision_mismatch += int(((occ != ref["occupied"]) & clear).sum())
            for k, res in self.kept:
                if k != r:
                    continue
                e, n = res["energy"].to(clear.device), res["noise"].to(clear.device)
                gap = (e.double() - ref["energy"]).abs() / ref["energy"].mean(-1, keepdim=True)
                gaps["energy_gap"] = max(gaps["energy_gap"], float(gap.max()))
                gaps["noise_gap"] = max(gaps["noise_gap"],
                                        float(((n.double() - ref["noise"]).abs() / ref["noise"]).max()))
                o = res["occupied"].to(clear.device)
                decision_mismatch += int(((o != ref["occupied"]) & clear).sum())
                decision_mismatch += int((o != (e > ratio * n)).sum())
            del ref, thr, clear
        checks = {k: (v, limits[k]) for k, v in gaps.items()}
        checks["decision_mismatch"] = (float(decision_mismatch), 0.0)
        checks["repeat_mismatch"] = (float(repeat_mismatch), 0.0)
        failed = repeat_mismatch + decision_mismatch + (not self.read)
        return checks, failed
