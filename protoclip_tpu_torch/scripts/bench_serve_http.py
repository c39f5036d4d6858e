"""Measure the HTTP serving front-end's micro-batching on the card (the
port's counterpart of ``scripts/bench_serve_http.py``).

Compares sequential vs concurrent small requests against ``python -m
protoclip_tpu_torch.cli.serve`` and reports request throughput and the
/statz dispatch counts and mean fill.  The point being measured: a bundle
bucket runs a fixed-size batch, so a small request costs one device
dispatch -- unless concurrent requests coalesce (``toolkit/microbatch.py``),
in which case N requests share one.

One process owns the card at a time: the bundle export runs in a child
that exits before the server starts; the server child is then the only
process on the card, and this process makes no CUDA call (it drives the
server through the shipped ``protoclip_tpu_torch.client.ServeClient``, the
client users deploy, so the bench measures the real path).  The server is
stopped in a ``finally``, whatever fails.

    python -m protoclip_tpu_torch.scripts.bench_serve_http --int8 --batch 256 \
        --buckets 8 64 --requests 32 --images-per-request 8 [--device cpu]
"""

from __future__ import annotations

import argparse
import concurrent.futures as futures
import io
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def export_bundle(args) -> None:
    """Export in a child that releases the card on exit, through the export
    CLI: the bench measures the bundle a user deploys."""
    cmd = [
        sys.executable, "-m", "protoclip_tpu_torch.cli.export",
        "--backbone", args.backbone, "--out", args.bundle,
        "--batch", str(args.batch), "--device", args.device,
    ]
    if args.int8:
        cmd.append("--int8")
    if args.buckets:
        cmd += ["--buckets", *map(str, args.buckets)]
    subprocess.run(cmd, check=True, cwd=REPO)


def wait_healthz(client, server: subprocess.Popen, timeout_s: float) -> dict:
    """Poll /healthz until it answers 200; raise if the server exits first
    or the deadline passes."""
    from protoclip_tpu_torch.client import ServeError

    deadline = time.monotonic() + timeout_s
    last = None
    while time.monotonic() < deadline:
        if server.poll() is not None:
            raise RuntimeError(f"the server exited with code {server.returncode} "
                               f"before it became healthy")
        try:
            return client.healthz()
        except (OSError, ServeError) as exc:  # not listening yet, or degraded
            last = exc
            time.sleep(0.5)
    raise RuntimeError(f"server never became healthy: {last}")


def make_images(n_images: int, px: int) -> list:
    """Pre-encoded PNG bytes (ServeClient passes encoded bytes through
    untouched, so the per-request client cost is just base64+json)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    encoded = []
    for _ in range(n_images):
        img = Image.fromarray(rng.integers(0, 256, (px, px, 3)).astype("uint8"))
        buf = io.BytesIO()
        img.save(buf, "PNG")
        encoded.append(buf.getvalue())
    return encoded


def run_load(client, images: list, n_requests: int, workers: int) -> dict:
    def post(_):
        return client.encode(images).shape[0]

    before = client.statz()["/encode"]
    t0 = time.perf_counter()
    if workers == 1:
        done = sum(post(i) for i in range(n_requests))
    else:
        with futures.ThreadPoolExecutor(workers) as pool:
            done = sum(pool.map(post, range(n_requests)))
    dt = time.perf_counter() - t0
    after = client.statz()["/encode"]
    return {
        "requests": n_requests,
        "workers": workers,
        "seconds": round(dt, 3),
        "images": done,
        "img_per_s": round(done / dt, 1),
        "req_per_s": round(n_requests / dt, 1),
        "dispatches": after["dispatches"] - before["dispatches"],
        "mean_fill": round(
            (after["images"] - before["images"])
            / max(1, after["dispatches"] - before["dispatches"]), 1),
    }


def stop(server: subprocess.Popen) -> None:
    server.terminate()
    try:
        server.wait(timeout=15)
    except subprocess.TimeoutExpired:
        server.kill()
        server.wait()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--backbone", default="ViT-B/16")
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--int8", action="store_true")
    parser.add_argument("--bundle", default=os.path.join(tempfile.gettempdir(),
                                                         "serve_bench_bundle"))
    parser.add_argument("--port", type=int, default=8439)
    parser.add_argument("--requests", type=int, default=32)
    parser.add_argument("--images-per-request", type=int, default=8)
    parser.add_argument("--coalesce-ms", type=float, default=5.0)
    parser.add_argument("--warmup-timeout", type=float, default=900.0,
                        help="seconds for the server to load the bundle and capture its graphs")
    parser.add_argument("--skip-export", action="store_true",
                        help="reuse an existing --bundle dir")
    parser.add_argument(
        "--buckets", type=int, nargs="*", default=None,
        help="export bucketed batch sizes (e.g. --buckets 8 64): underfull "
        "serving dispatches pad to the smallest bucket instead of --batch",
    )
    parser.add_argument("--device", default="cuda",
                        help="torch device of the export and the server (default: the card)")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from protoclip_tpu_torch.client import ServeClient

    if not args.skip_export:
        print("[bench-serve] exporting bundle (subprocess owns the card)...", flush=True)
        export_bundle(args)

    server = subprocess.Popen(
        [sys.executable, "-m", "protoclip_tpu_torch.cli.serve",
         "--bundle", args.bundle, "--port", str(args.port),
         "--coalesce-ms", str(args.coalesce_ms), "--host", "127.0.0.1",
         "--device", args.device],
        cwd=REPO,
    )
    try:
        client = ServeClient(f"http://127.0.0.1:{args.port}", timeout=600.0)
        health = wait_healthz(client, server, args.warmup_timeout)
        print(f"[bench-serve] healthz: {health}", flush=True)
        px = health["image_resolution"]
        images = make_images(args.images_per_request, px)
        client.encode(images)  # client-side warm (connection, json)

        serial = run_load(client, images, args.requests, workers=1)
        print(f"[bench-serve] serial    : {serial}", flush=True)
        concurrent = run_load(
            client, images, args.requests, workers=min(args.requests, 64)
        )
        print(f"[bench-serve] concurrent: {concurrent}", flush=True)
        speedup = concurrent["img_per_s"] / serial["img_per_s"]
        print(json.dumps({
            "metric": "serve_coalesce_speedup",
            "serial_img_per_s": serial["img_per_s"],
            "concurrent_img_per_s": concurrent["img_per_s"],
            "speedup": round(speedup, 2),
            "serial_dispatches": serial["dispatches"],
            "concurrent_dispatches": concurrent["dispatches"],
            "serial_mean_fill": serial["mean_fill"],
            "concurrent_mean_fill": concurrent["mean_fill"],
        }), flush=True)
    finally:
        stop(server)
    return 0


if __name__ == "__main__":
    sys.exit(main())
