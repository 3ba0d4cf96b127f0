"""The readings the limits of ``correct`` are set from, for one cell.

    python3 -m crn_bench.calibrate --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds 3 [--out readings.jsonl]

In one process on the card, one run of the cell (:func:`crn_bench.run.execute`:
its set-up, a short window at the cell's own load and the comparison with
the reference) for each seed, giving the program's readings (the lower end
of each limit), and one with the control in the program's place for each
control seed (the upper end; the run's own ``correct`` has to come out
false).  One JSON line per run, on standard output and appended to ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import io
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    from crn_bench.run import _environment, execute

    _environment()
    import torch

    if not torch.cuda.is_available():
        print("crn_bench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    runs = [(int(s), False) for s in args.seeds.split(",") if s]
    runs += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        log = io.StringIO()
        t0 = time.time()
        try:
            r = execute(args.workload, seed, args.seconds, False, control=control, started=t0, log=log)
            line = {"cell": args.workload, "seed": seed, "control": control, "correct": r["correct"],
                    "failed": r["failed"], "attempted": r["attempted"],
                    "readings": {k: v["value"] for k, v in r["checks"].items()},
                    "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                    "notes": [ln for ln in log.getvalue().splitlines() if ln.startswith("not compared")],
                    "seconds": time.time() - t0}
        except Exception as e:  # a control that crashes has failed; record it and go on
            line = {"cell": args.workload, "seed": seed, "control": control, "correct": False,
                    "error": f"{e.__class__.__name__}: {e}"}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
