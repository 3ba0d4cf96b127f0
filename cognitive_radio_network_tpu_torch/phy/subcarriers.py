"""OFDM subcarrier allocation: null/pilot/data maps.

Port of ``cognitive_radio_network_tpu/phy/subcarriers.py`` (host numpy,
copied).  Reproduces the three allocation modes of the reference's config
layer (src/crts.cpp:388-481 and include/crts.hpp:96-100):

* ``default_alloc``   — liquid-style default (guard bands around Nyquist, DC
  null, pilots every P carriers), the ECR default
  (src/extensible_cognitive_radio.cpp:70-72);
* ``standard_alloc``  — parameterized central nulls / guard subcarriers /
  pilot frequency (src/crts.cpp:391-424);
* ``custom_alloc``    — explicit (type, count) run-length spec starting at
  the center offset and wrapping, mirroring the reference's
  sc_type_N/sc_num_N parsing order (src/crts.cpp:429-481).

Subcarrier indices are **unshifted** (DC at index 0, negative frequencies in
the upper half), matching both liquid and the sensing bin maps.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "SC_NULL",
    "SC_PILOT",
    "SC_DATA",
    "default_alloc",
    "standard_alloc",
    "custom_alloc",
    "counts",
]

SC_NULL = 0
SC_PILOT = 1
SC_DATA = 2


def default_alloc(m: int) -> np.ndarray:
    """Liquid-style default: DC null, guard max(2, m/10) below Nyquist,
    pilots every 8 (or 4 for small m) offset by half the spacing."""
    g = max(2, m // 10)
    p = 8 if m > 34 else 4
    p2 = p // 2
    alloc = np.full(m, SC_NULL, np.uint8)
    m2 = m // 2
    for i in range(1, m2 - g):
        t = SC_PILOT if (i + p2) % p == 0 else SC_DATA
        alloc[i] = t  # positive frequencies
        alloc[m - i] = t  # negative frequencies
    return alloc


def standard_alloc(
    m: int, guard_subcarriers: int, central_nulls: int, pilot_freq: int
) -> np.ndarray:
    """Parameterized allocation, bit-compatible with src/crts.cpp:406-424."""
    alloc = np.empty(m, np.uint8)
    for i in range(m):
        if i < central_nulls // 2 or m - i - 1 < central_nulls // 2:
            alloc[i] = SC_NULL
        elif (i + 1 > m // 2 - guard_subcarriers) and (i < m // 2 + guard_subcarriers):
            alloc[i] = SC_NULL
        elif int(abs(m / 2.0 - i - 0.5)) % pilot_freq == 0:
            alloc[i] = SC_PILOT
        else:
            alloc[i] = SC_DATA
    return alloc


def custom_alloc(m: int, spec: list[tuple[str, int]]) -> np.ndarray:
    """Run-length spec [("null", n), ("pilot", n), ("data", n), ...] laid out
    from the band center, wrapping like src/crts.cpp:440-477."""
    types = {"null": SC_NULL, "pilot": SC_PILOT, "data": SC_DATA}
    alloc = np.full(m, SC_NULL, np.uint8)
    j = 0
    offset = m // 2
    for name, count in spec:
        t = types[name]
        for _ in range(count):
            if j >= m // 2:
                offset = -(m // 2)
            if j + offset >= m or j >= m:
                raise ValueError("custom allocation spec longer than fft size")
            alloc[j + offset] = t
            j += 1
    return alloc


def counts(alloc: np.ndarray) -> tuple[int, int, int]:
    """(num_null, num_pilot, num_data)."""
    return (
        int(np.sum(alloc == SC_NULL)),
        int(np.sum(alloc == SC_PILOT)),
        int(np.sum(alloc == SC_DATA)),
    )
