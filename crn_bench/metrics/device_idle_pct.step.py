"""Idle share (%) of the device over the traced window of device-resident
streaming receive: one less the union of device-operation intervals over the
window."""

from crn_bench.harness import idle_pct


def read(rec):
    return idle_pct(rec)
