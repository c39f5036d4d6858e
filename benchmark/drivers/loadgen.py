"""The open-loop load generator of the serving cells, a process of its own
(it shares no interpreter lock with the server and imports no torch).

    python3 -m benchmark.drivers.loadgen --url URL --route /encode --jpegs DIR \
        --traffic TRAFFIC.json --seed N --seconds S --out ANSWERS.npz

It reads the JPEGs (base64 once, as a client holds them encoded), draws
the schedule, prints ``ready`` and waits for one line on stdin: the
``time.monotonic()`` at which the warm-up traffic starts.  The window
opens ``warmup_s`` later and lasts ``--seconds``.  Requests are sent at
their due times whatever is still in flight, each timed from its due time
to the end of its answer.  The body is the server's wire protocol
(``{"images": [<b64 jpeg>, ...]}``, JSON).

The schedule of a window of ``n = rate * seconds`` requests: the gaps are
the ``n`` quantiles ``-ln(1 - (i + 1/2) / n) / rate`` of the exponential
distribution, in an order drawn from the seed and scaled to fill the
window, so that every seed offers the same arrivals and sizes in another
order (the warm-up likewise).  Images a request: each count of
``images_per_request`` equally often, in a seeded order; which JPEGs:
uniform.
"""

from __future__ import annotations

import argparse
import base64
import concurrent.futures as futures
import http.client
import json
import sys
import time
import urllib.parse
from pathlib import Path

import numpy as np

from benchmark.stats import p95


def arrivals(rng: np.random.Generator, rate: float, seconds: float) -> np.ndarray:
    """Due times in [0, seconds) of ``round(rate * seconds)`` requests."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = rng.permutation(gaps)
    starts = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return starts * (seconds / gaps.sum())


def sizes(rng: np.random.Generator, n: int, lo: int, hi: int) -> np.ndarray:
    """``n`` request sizes, each of lo..hi equally often, in a seeded order."""
    cycle = np.arange(lo, hi + 1)
    return rng.permutation(np.resize(cycle, n))


def _send(host: str, port: int, route: str, body: bytes, timeout: float):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", route, body, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        end = time.monotonic()
        return resp.status, data, end
    finally:
        conn.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--url", required=True)
    ap.add_argument("--route", default="/encode")
    ap.add_argument("--jpegs", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rate", type=float, help="requests/s (default: the traffic file's)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    traffic = json.loads(Path(args.traffic).read_text())
    rate = args.rate or traffic["rate_per_s"]
    url = urllib.parse.urlparse(args.url)
    b64 = [base64.b64encode(p.read_bytes()).decode()
           for p in sorted(Path(args.jpegs).glob("*.jpg"))]
    rng = np.random.default_rng(args.seed)
    warm = arrivals(rng, rate, traffic["warmup_s"]) - traffic["warmup_s"]
    window = arrivals(rng, rate, args.seconds)
    due = np.concatenate([warm, window])
    counts = sizes(rng, len(due), *traffic["images_per_request"])
    picks = [rng.integers(0, len(b64), c) for c in counts]
    timeout = traffic["drain_s"] + args.seconds
    print("ready", flush=True)
    t_open = float(sys.stdin.readline()) + traffic["warmup_s"]

    def request(i: int):
        body = ('{"images": ["' + '", "'.join(b64[j] for j in picks[i]) + '"]}').encode()
        try:
            status, data, end = _send(url.hostname, url.port, args.route, body, timeout)
        except OSError as exc:
            return None, time.monotonic(), f"{type(exc).__name__}: {exc}"
        if status != 200:
            return None, end, f"HTTP {status}: {data[:200]!r}"
        feats = np.asarray(json.loads(data)["features"], np.float32)
        return feats, end, None

    late, pending = [], []
    with futures.ThreadPoolExecutor(max_workers=traffic["max_in_flight"]) as pool:
        for i, d in enumerate(due):
            wait = t_open + d - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            late.append(time.monotonic() - (t_open + d))
            pending.append(pool.submit(request, i))
        results = [f.result() for f in pending]

    first = len(warm)
    ok = np.asarray([r[2] is None for r in results[first:]])
    end = np.asarray([r[1] - t_open for r in results[first:]])
    latency = np.where(ok, end - window, np.inf)
    feats = [r[0] for r in results[first:] if r[0] is not None]
    rows = np.asarray([0 if r[0] is None else len(r[0]) for r in results[first:]])
    np.savez(args.out, due=window, end=end, ok=ok, counts=counts[first:], rows=rows,
             picks=np.concatenate(picks[first:]),
             features=np.concatenate(feats) if feats else np.zeros((0, 0), np.float32))
    late_w = np.asarray(late[first:])
    errors = [r[2] for r in results[first:] if r[2] is not None]
    print(json.dumps({"requests": int(len(window)), "failed": int((~ok).sum()),
                      "p95_ms": p95(latency) * 1e3,
                      "late_ms_p50": float(np.median(late_w) * 1e3),
                      "late_ms_p99": float(np.quantile(late_w, 0.99) * 1e3),
                      "late_ms_max": float(late_w.max() * 1e3),
                      "errors": errors[:3]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
