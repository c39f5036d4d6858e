"""Readings that set a cell's limits: the numbers compared, for the
program or (``--control``) for its control, on many seeds in one process.

    python3 -m benchmark.calibrate --workload <name> --seconds 5 --seeds 11 12 13 [--control]

The control is the program's own W8A8 path (K3), one precision below
the configuration's bf16.  Each seed builds the cell anew (weights,
inputs, program), runs a short window at the cell's own load and
compares every answer of it, as a run does; one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    from benchmark import harness

    for seed in args.seeds:
        line = {"workload": args.workload, "seed": seed, "control": args.control}
        try:
            result = harness.run_cell(args.workload, seed, args.seconds, False,
                                      t0=time.perf_counter(), control=args.control)
            line.update(checks={k: c["value"] for k, c in result["checks"].items()},
                        correct=result["correct"], attempted=result["attempted"],
                        metrics={k: m["value"] for k, m in result["metrics"].items()})
        except Exception as exc:  # noqa: BLE001 - a control that crashes has failed
            traceback.print_exc()
            line["error"] = f"{type(exc).__name__}: {exc}"
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
