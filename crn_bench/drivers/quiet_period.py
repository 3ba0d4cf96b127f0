"""Synchronized quiet periods: a fleet's sensing cycles served as they come due.

Every ``sensing_delay_ms`` all of the fleet's nodes finish a sensing cycle at
once (IEEE 802.22's quiet period), each late or early by its clock's error,
drawn uniformly within ``clock_error_s``.  The schedule is fixed before the
window (an open loop: it does not wait for the server); between turns the
server polls the clock and never sleeps, so that a late wake-up from a sleep
(on an H100 host, over 0.5 ms late in 1-19 of 509 quiet periods a run, up to
12.6 ms) is not counted as the program's latency.  One server loop
takes every request that is due (at most a fleet's worth a turn) and hands
their ten buffers each, consecutive rows of a host pool the seed filled, to
one ``make_sense_fn`` call (the program uploads them), then reads the
decisions back to the host.  A request's latency runs from its due time to
its decision on the host;
``decision_p95_ms`` is the 95th percentile over every request due in the
window, the ones served after its close included.

Every request's decision is compared with the reference's for its cycle;
the whole outputs (spectrum, features, outputs) of turns kept by a reservoir
sample drawn from the seed are compared too.  ``control`` hands the program
planes rounded to bfloat16 (the values its bfloat16 path reads).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from crn_bench.drivers._sensing import SenseChecks, sense_function
from crn_bench.reference.sense import make_scene

LEAD_S = 0.01  # the first quiet period starts this long after the window opens


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, spans, control=False):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.spans, self.control = spans, control
        self.nodes = int(config["fleet"]["nodes"])
        self.period = config["sense"]["sensing_delay_ms"] / 1e3
        self.counters = {}

    def setup(self) -> None:
        s = self.config["sense"]
        a, n = s["averaging"], s["fft_length"]
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        pool = int(self.traffic["pool_cycles"])
        xr, xi = make_scene(gen, pool, s, self.config["scene"])
        self.pool_dev = (xr, xi)  # the reference's copy
        if self.control:  # bfloat16 planes, as numpy holds no bfloat16: their float32 values
            xr, xi = (v.bfloat16().float() for v in (xr, xi))
        # requests take the pool's cycles in the order they come due, so a
        # turn's requests are consecutive rows; the pool's first fleet of
        # cycles is repeated after its end, so every turn's rows are one view
        wrap = np.arange(pool + self.nodes) % pool
        self.pool = [v.reshape(pool, a * n).cpu().numpy()[wrap] for v in (xr, xi)]
        self.size = pool
        self.fn, self.params = sense_function(self.config, self.device)
        for c in range(1, self.nodes + 1):  # every batch size a turn can have
            self._serve(0, c)

    def _serve(self, row: int, c: int):
        """One turn: the requests' planes (rows ``row`` to ``row + c`` of the
        pool, a view), one sense call, decisions to the host."""
        n = self.config["sense"]["fft_length"]
        planes = tuple(p[row: row + c].reshape(-1, n) for p in self.pool)
        with self.spans("sense_call"):
            res = self.fn(planes, self.params)
        with self.spans("read_decisions"):
            dec = res["decision"].cpu().numpy()
        return res, dec

    def window(self, seconds: float) -> dict:
        if not self.spans.on:
            return self._window(seconds)
        from crn_bench.harness import wrapped

        # the span "upload": every Tensor.to, which is how the call moves the planes to the card
        with wrapped(torch.Tensor, "to", self.spans, "upload"):
            return self._window(seconds)

    def _window(self, seconds: float) -> dict:
        nodes, pool = self.nodes, self.size
        bursts = max(1, int(np.ceil(seconds / self.period)))
        jitter = float(self.traffic["clock_error_s"])
        draw = np.random.default_rng([self.seed, 2])
        offsets = draw.uniform(-jitter, jitter, (bursts, nodes))
        t0 = time.perf_counter() + LEAD_S
        due = (t0 + self.period * np.arange(bursts)[:, None] + offsets).ravel()
        order = np.argsort(due, kind="stable")
        due_sorted = due[order]
        pool_idx = np.empty(bursts * nodes, np.int64)
        pool_idx[order] = np.arange(bursts * nodes) % pool  # by due order
        served = np.full(due.shape, np.nan)
        decisions = np.full(due.shape, -1, np.int32)
        keep = int(self.traffic["kept_turns"])
        sizes, took, idle, late = [], [], [], []
        last = time.perf_counter()
        self.kept, turns = [], 0
        ptr, total = 0, len(due)
        while ptr < total:
            now = time.perf_counter()
            wait = due_sorted[ptr] - now
            if wait > 0:  # poll: a sleep on a shared host can wake milliseconds late
                continue
            # every due request, at most a fleet's worth (the largest batch warmed up)
            end = min(int(np.searchsorted(due_sorted, now, side="right")), ptr + nodes)
            batch = order[ptr:end]
            res, dec = self._serve(ptr % pool, len(batch))
            served[batch] = t = time.perf_counter()
            sizes.append(len(batch))
            took.append(t - now)
            idle.append(now - last)
            late.append(now - due_sorted[ptr])  # how long its earliest request waited for the server
            last = t
            decisions[batch] = dec
            if turns < keep:
                self.kept.append((pool_idx[batch], res))
            elif (j := int(draw.integers(turns + 1))) < keep:
                self.kept[j] = (pool_idx[batch], res)
            turns += 1
            ptr = end
        lat = (served - due) * 1e3
        per_burst = served.reshape(bursts, nodes)
        first_due = due.reshape(bursts, nodes).min(1)
        self.counters = {"bursts": list(zip(first_due.tolist(), per_burst.max(1).tolist())),
                         "turns": turns}
        self.pool_idx, self.decisions = pool_idx, decisions
        p50, p95 = (float(np.percentile(lat, q)) for q in (50, 95))
        # a quiet period's first turn follows the server's wait: its lateness is the wake-up's
        wake = np.array([w for w, i in zip(late, idle) if i > self.period / 2]) * 1e3
        return {"metrics": {"decision_p95_ms": p95},
                "attempted": total,
                "notes": [f"requests {total} in {bursts} quiet periods, {turns} turns; decision "
                          f"latency ms p50 {p50!r} p95 {p95!r} max {float(lat.max())!r}; a turn: mean "
                          f"{float(np.mean(sizes))!r} requests, mean {float(np.mean(took)) * 1e3!r} "
                          f"ms, max {float(np.max(took)) * 1e3!r} ms",
                          f"server woke after the first due time, ms: p50 {float(np.median(wake))!r} "
                          f"p95 {float(np.percentile(wake, 95))!r} max {float(wake.max())!r}; "
                          f"woke over 0.5 ms late in {int((wake > 0.5).sum())} of {len(wake)}",
                          "slowest turns (requests, ms, ms idle before): " + ", ".join(
                              f"({sizes[k]}, {took[k] * 1e3:.3f}, {idle[k] * 1e3:.3f})"
                              for k in np.argsort(took)[::-1][:8])]}

    def release(self) -> None:
        del self.fn, self.params
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def check(self):
        checks = SenseChecks(self.config, self.traffic["limits"])
        ref = checks.reference(*self.pool_dev)
        n = len(self.decisions)
        checks.decisions(self.decisions, None, ref, torch.from_numpy(self.pool_idx))
        for rows, res in self.kept:
            checks.full(res, ref, torch.from_numpy(rows))
        self.info = {"output_gap": checks.output_gap}
        unserved = int((self.decisions < 0).sum())
        return checks.result(), checks.decision_mismatch + unserved + (n == 0)
