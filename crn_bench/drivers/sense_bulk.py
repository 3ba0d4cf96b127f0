"""Bulk sensing: back-to-back ``make_sense_fn`` dispatches on device-resident planes.

Each dispatch senses ``cycles`` cycles on planes already on the card, taken in
turn from a ring of distinct batches the benchmark synthesized there from the
seed (together larger than the card's L2 cache).  Its decisions and MLP
outputs are copied to pinned host memory and read by the client; at most
``in_flight`` dispatches are outstanding.  ``detect_msps`` is every input
sample whose decisions reached the host, over the window's wall time.

The client reads each dispatch's decisions as a user of the sensing chain
would: it counts the occupied cycles.  A copy of the first dispatch of each
batch is kept.  After the window, every dispatch's count is compared with
that first dispatch's count for its batch (a repeat that differs counts as
failed), and each batch's first dispatch is compared with the reference.  A
reservoir sample of dispatches drawn from the seed is compared too: its
whole outputs (spectrum, features, outputs, decisions) against the
reference, and its decisions and outputs as bytes against the first
dispatch of its batch.  ``control`` feeds the program bfloat16 planes (its
own lower-precision path) while the reference reads the float32 planes.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from crn_bench.drivers._sensing import SenseChecks, sense_function
from crn_bench.reference.sense import make_scene


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, spans, control=False):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.spans, self.control = spans, control
        s = config["sense"]
        self.cycles = int(traffic["cycles"])
        self.samples = self.cycles * s["averaging"] * s["fft_length"]
        self.counters = {"cycles": self.cycles, "averaging": s["averaging"],
                         "fft_length": s["fft_length"], "itemsize": 2 if control else 4}

    def setup(self) -> None:
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.ring = [make_scene(gen, self.cycles, self.config["sense"], self.config["scene"])
                     for _ in range(int(self.traffic["ring"]))]
        self.inputs = ([(r.bfloat16(), i.bfloat16()) for r, i in self.ring] if self.control
                       else self.ring)
        self.fn, self.params = sense_function(self.config, self.device)
        pin = self.device != "cpu"
        self.slots = [(torch.empty(self.cycles, dtype=torch.int32, pin_memory=pin),
                       torch.empty(self.cycles, 3, dtype=torch.float32, pin_memory=pin),
                       torch.cuda.Event() if pin else None)
                      for _ in range(int(self.traffic["in_flight"]))]
        for planes in self.inputs:  # every batch once, as the window runs them
            res = self.fn(planes, self.params)
            self.slots[0][0].copy_(res["decision"])
            self.slots[0][1].copy_(res["outputs"])

    def _read(self, entry) -> None:
        """The client reads a dispatch's decisions once they are on the host:
        it counts the occupied cycles (and keeps the first dispatch of each
        batch whole)."""
        r, (dec, out, done) = entry
        if done is not None:
            done.synchronize()
        d = dec.numpy()
        self.occupied.append((r, int(np.count_nonzero(d))))
        if r not in self.first:
            self.first[r] = (d.copy(), out.numpy().copy())

    def window(self, seconds: float) -> dict:
        fn, params, spans, inputs = self.fn, self.params, self.spans, self.inputs
        keep = int(self.traffic["kept_dispatches"])
        draw = np.random.default_rng([self.seed, 1]).random(1 << 20)  # the reservoir's draws
        self.first, self.kept, self.occupied = {}, [], []
        inflight = collections.deque()
        slots = self.slots
        i = 0
        t0 = time.perf_counter()
        t_end = t0 + seconds
        per_second = [0] * (int(seconds) + 1)
        while (now := time.perf_counter()) < t_end:
            per_second[int(now - t0)] += 1
            if len(inflight) == len(slots):
                with spans("client_read"):
                    self._read(inflight.popleft())
            r = i % len(inputs)
            with spans("sense_call"):
                res = fn(inputs[r], params)
            slot = slots[i % len(slots)]
            with spans("copy_back"):
                slot[0].copy_(res["decision"], non_blocking=True)
                slot[1].copy_(res["outputs"], non_blocking=True)
                if slot[2] is not None:
                    slot[2].record()
            if i < keep:  # reservoir sample of whole dispatches
                self.kept.append((r, res))
            elif (j := int(draw[i % len(draw)] * (i + 1))) < keep:
                self.kept[j] = (r, res)
            inflight.append((r, slot))
            i += 1
        while inflight:
            with spans("client_read"):
                self._read(inflight.popleft())
        wall = time.perf_counter() - t0
        read = len(self.occupied)
        return {"metrics": {"detect_msps": read * self.samples / wall / 1e6},
                "attempted": read,
                "notes": [f"dispatches read {read} in {wall!r} s; dispatches issued in each "
                          f"second {per_second}"]}

    def release(self) -> None:
        del self.fn, self.params, self.slots
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def check(self):
        checks = SenseChecks(self.config, self.traffic["limits"])
        rows = slice(0, self.cycles)
        first_count = {r: int(np.count_nonzero(dec)) for r, (dec, _out) in self.first.items()}
        repeat_mismatch = sum(1 for r, n in self.occupied if n != first_count[r])
        for r, res in self.kept:  # the sample, as bytes, against its batch's first dispatch
            dec, out = self.first[r]
            repeat_mismatch += not (np.array_equal(res["decision"].cpu().numpy(), dec)
                                    and np.array_equal(res["outputs"].cpu().numpy(), out))
        for r, (xr, xi) in enumerate(self.ring):
            if r not in self.first:
                continue
            ref = checks.reference(xr, xi)
            checks.decisions(*self.first[r], ref, rows)
            for k, res in self.kept:
                if k == r:
                    checks.full(res, ref, rows)
            del ref
        self.info = {"output_gap": checks.output_gap}
        failed = repeat_mismatch + checks.decision_mismatch + (not self.occupied)
        return checks.result({"repeat_mismatch": repeat_mismatch}), failed
