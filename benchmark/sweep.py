"""Find the knee of a serving cell: the highest offered rate the server
sustains without a growing backlog, by one sweep on the card.

    python3 -m benchmark.sweep --workload vit-b16.serve-encode --seed 5 --seconds 10 \
        --rates 40 60 80 100

One server for the whole sweep; at each rate a fresh load generator runs
the cell's open-loop traffic for a window.  One JSON line a rate: the
requests and images completed a second, p50 and p95 latency from the due
time, and the backlog's growth, the median latency of the window's last
third of requests over its first third (about 1 when the queue is
steady, growing with the window when it is not).  The rate the cell runs
at is then fixed in its traffic file by hand, at about four fifths of the
knee.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)

    from benchmark import harness
    from benchmark.drivers.serve import Driver
    from benchmark.stats import p95

    bench = harness.Bench()
    with harness.context(bench, args.workload, args.seed, args.seconds, False, "cuda",
                         False) as ctx:
        driver = Driver(ctx)
        try:
            for rate in args.rates:
                counters = driver.measure(rate)
                latency = np.asarray(counters["latency_s"])
                due = driver.result["due"]
                third = max(1, len(latency) // 3)
                print(json.dumps({
                    "rate_per_s": rate, "requests": len(latency), "failed": counters["failed"],
                    "completed_images_per_s": counters["images_served"] / counters["window_s"],
                    "p50_ms": float(np.median(latency) * 1e3), "p95_ms": p95(latency) * 1e3,
                    "backlog_growth": float(np.median(latency[-third:])
                                            / np.median(latency[:third])),
                    "p95_ms_by_5s": [p95(latency[due // 5 == k]) * 1e3
                                     for k in range(int(np.ceil(args.seconds / 5)))],
                    "fill": counters["images_served"] / max(1, counters["dispatches"]),
                    "server_cores": counters["server_cpu_s"] / counters["window_s"],
                    "load_generator": counters["log"][0], "host": counters["log"][-1]}),
                      flush=True)
        finally:
            driver.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
