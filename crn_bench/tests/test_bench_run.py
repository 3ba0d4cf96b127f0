"""A run's result line, its refusal without a card, and the absence of JAX.

The rehearsals here drive :func:`crn_bench.run.execute` on the CPU (the
kernels' plain versions) at the small sizes of ``conftest.py``; the run on
the card is the same code with ``device="cuda"``.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from crn_bench import harness
from crn_bench.tests.conftest import SMALL, rehearse

KEYS = {"correct", "attempted", "failed", "metrics", "device", "build", "checks"}
CELLS = sorted(SMALL)


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_keys(cell):
    r = rehearse(cell, 2**31 + 99)
    assert set(r) == KEYS and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    want = {m["name"] for m in harness.cell_metrics(bench, cell, "end_to_end")}
    assert set(r["metrics"]) == want and "setup_s" in want
    assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
    assert all(set(v) == {"value", "limit"} for v in r["checks"].values())
    json.dumps(r)


def test_traced_result_line_keys():
    cell = "eight_node.rx_stream"
    r = rehearse(cell, 7, trace=True, seconds=0.2, trace_seconds=0.2)
    assert set(r) == KEYS | {"breakdown"} and list(r)[-1] == "checks"
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(r["device"])
    per_layer = {m["name"] for m in harness.load_json(harness.ROOT / "BENCHMARK.json")["per_layer"]}
    assert set(r["metrics"]) <= per_layer  # the CPU trace has no device records: those stay silent


def test_no_card_no_result():
    # the card, where there is one, is hidden from the run
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, "-m", "crn_bench.run", "--workload", "eight_node.rx_stream",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=harness.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "cognitive_radio_network_tpu_torch_like", object())
    assert "cognitive_radio_network_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in harness.forbidden_modules()


def test_nothing_loads_jax():
    """Import the run and every driver, rehearse every cell, then look at sys.modules."""
    code = textwrap.dedent(f"""
        import pkgutil, importlib, sys
        import crn_bench.run, crn_bench.drivers, crn_bench.calibrate
        for m in pkgutil.iter_modules(crn_bench.drivers.__path__):
            importlib.import_module("crn_bench.drivers." + m.name)
        from crn_bench.tests.conftest import rehearse
        for cell in {CELLS!r}:
            assert rehearse(cell, 3)["correct"]
        from crn_bench import harness
        for name in sorted(harness.BENCH.glob("metrics/*.py")):
            harness.metric_reader(name.stem)
        tops = {{m.split(".", 1)[0] for m in sys.modules}}
        assert "cognitive_radio_network_tpu_torch" in tops
        print(sorted(tops & {{"jax", "jaxlib", "flax", "cognitive_radio_network_tpu"}}))
    """)
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
