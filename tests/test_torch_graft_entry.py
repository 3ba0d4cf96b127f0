"""The port's entry points (``cognitive_radio_network_tpu_torch/graft_entry.py``):
``entry()`` runs and decides as the JAX package's ``__graft_entry__.entry()``
on the same planes, and ``dryrun_multichip(n)`` passes on 1, 2 and 8 gloo
ranks on the CPU, as tests/test_graft_entry.py runs the reference's.

The port's dry run asserts more than the reference's: each stage equals its
one-device counterpart (the loss within rtol 1e-5, the frames byte for
byte, the energy at ``WidebandConfig()`` within rtol 1e-5), so a pass here is
a numerical check, not only liveness.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from cognitive_radio_network_tpu_torch import graft_entry


def test_entry_runs_and_decides_as_the_reference():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import jax

    import __graft_entry__ as reference

    fn, args = graft_entry.entry(device="cpu")
    got = fn(*args).numpy()
    assert got.shape == (16,)
    assert set(np.unique(got)).issubset({0, 1, 2, 3})
    jfn, jargs = reference.entry()
    np.testing.assert_array_equal(np.asarray(args[0]), np.asarray(jargs[0]))
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jfn)(*jargs)))


@pytest.mark.parametrize("n", [1, 2, 8])
def test_dryrun_multichip(n, capsys):
    out = graft_entry.dryrun_multichip(n, backend="gloo", device="cpu")
    assert out["phylink_frames"] == out["adaptive_frames"] == out["placed"] == (2 if n > 1 else 1)
    assert abs(out["loss"] - out["one_device_loss"]) <= 1e-5 * abs(out["one_device_loss"])
    assert out["step"] == 1
    assert out["wideband_cycles"] == 2  # each rank's block at M=64, P=8 held to one device's
    assert "dryrun_multichip ok" in capsys.readouterr().out
