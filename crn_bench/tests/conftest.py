"""Small sizes for the benchmark's CPU tests: every cell's traffic, cut so a
rehearsal on the CPU takes a second or two (the run itself never cuts)."""

import io

from crn_bench import harness

SMALL = {
    "predictive_model.sense_bulk": {"cycles": 32, "ring": 2, "kept_dispatches": 2},
    "predictive_model.quiet_period": {"pool_cycles": 96, "kept_turns": 4},
    "eight_node.rx_stream": {"min_tape_samples": 100_000},
    "predictive_model.rx_stream": {"min_tape_samples": 100_000},
}
SECONDS = {"predictive_model.sense_bulk": 0.3, "predictive_model.quiet_period": 0.25,
           "eight_node.rx_stream": 1.0, "predictive_model.rx_stream": 0.1}


def rehearse(cell: str, seed: int = 2**31 + 17, *, trace: bool = False, seconds=None, control=False,
             **extra) -> dict:
    """:func:`crn_bench.run.execute` on the CPU with the cell's traffic cut to SMALL (and ``extra``)."""
    from crn_bench.run import execute

    load = harness.load_cell

    def small(name):
        bench, c, config, traffic = load(name)
        return bench, c, config, {**traffic, **SMALL[name], **extra}

    harness.load_cell = small
    try:
        return execute(cell, seed, SECONDS[cell] if seconds is None else seconds, trace, device="cpu",
                       control=control, log=io.StringIO())
    finally:
        harness.load_cell = load
