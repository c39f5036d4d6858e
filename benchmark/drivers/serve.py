"""The HTTP service: ``cli/serve.py::build_server`` over a serving bundle
that ``cli/export.py`` writes from the seeded weights, in this process,
under open-loop load from ``loadgen.py`` in a process of its own.

The server runs the CLI's defaults (micro-batch fill window
``coalesce_ms``, PIL decode).  The window's counters: every request due
in it, timed from its due time to the end of its answer (a failed one is
infinite); this process's CPU seconds, which are the server's; the
micro-batcher's ``images`` and ``dispatches`` counters at its ends.  Every
image of every answer is held against the plain reference's features of
its JPEG.  No cell of ``BENCHMARK.json`` runs it yet: its tail holds no
bound (PERF.md); ``benchmark.sweep`` drives it to find the knee.
"""

from __future__ import annotations

import json
import os
import select
import subprocess
import sys
import threading
import time

import numpy as np

from benchmark import compare, host, inputs, weights
from benchmark.stats import p95
from benchmark.drivers import INPUTS, TRAFFIC, WEIGHTS
from benchmark.harness import ROOT

READY_TIMEOUT_S = 120


def export_bundle(ctx, state_dict, out: str, control: bool) -> None:
    """Write a bundle of ``state_dict`` as ``cli/export.py`` does from a
    weights file, with the traffic's batch and buckets."""
    import torch

    from protoclip_tpu_torch.cli import export as export_cli

    path = ctx.tmp / "clip.pt"
    torch.save(state_dict, path)
    export_cli.main(["--backbone", ctx.config["backbone"], "--weights", str(path), "--out", out,
                     "--batch", str(ctx.traffic["batch_size"]),
                     "--buckets", *map(str, ctx.traffic["buckets"]),
                     "--device", ctx.device] + (["--int8"] if control else []))
    os.remove(path)


class Driver:
    def __init__(self, ctx):
        from protoclip_tpu_torch.cli.serve import build_server

        self.ctx, cfg, traffic = ctx, ctx.config, ctx.traffic
        self.state_dict = weights.clip_state_dict(cfg, inputs.child_seed(ctx.seed, WEIGHTS),
                                                  ctx.device)
        bundle = str(ctx.tmp / "bundle")
        # the control is the program's own W8A8 bundle (K3)
        export_bundle(ctx, self.state_dict, bundle, ctx.control)
        self.server = build_server("127.0.0.1", 0, bundle=bundle, quiet=True,
                                   coalesce_ms=traffic["coalesce_ms"], device=ctx.device)
        self.batcher = self.server.RequestHandlerClass.routes["/encode"].batcher
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.jpegs = [inputs.jpeg(f, traffic["jpeg_quality"])
                      for f in inputs.frames(inputs.child_seed(ctx.seed, INPUTS), traffic["jpegs"])]
        jpeg_dir = ctx.tmp / "jpegs"
        jpeg_dir.mkdir()
        for i, raw in enumerate(self.jpegs):
            (jpeg_dir / f"{i:03d}.jpg").write_bytes(raw)
        self.traffic_path = ctx.tmp / "traffic.json"
        self.traffic_path.write_text(json.dumps(traffic))
        self.jpeg_dir = jpeg_dir
        self.loadgen = None

    def _start_loadgen(self, rate) -> None:
        """The load generator's process, once it has drawn its schedule."""
        host, port = self.server.server_address[:2]
        self.answers = self.ctx.tmp / "answers.npz"
        self.loadgen = subprocess.Popen(
            [sys.executable, "-m", "benchmark.drivers.loadgen", "--url", f"http://{host}:{port}",
             "--jpegs", str(self.jpeg_dir), "--traffic", str(self.traffic_path),
             "--seed", str(inputs.child_seed(self.ctx.seed, TRAFFIC)),
             "--seconds", str(self.ctx.seconds), "--out", str(self.answers)]
            + ([] if rate is None else ["--rate", str(rate)]),
            cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        ready, _, _ = select.select([self.loadgen.stdout], [], [], READY_TIMEOUT_S)
        line = self.loadgen.stdout.readline().strip() if ready else ""
        if line != "ready":
            self._stop_loadgen()
            raise RuntimeError(f"the load generator did not start: {line!r}")

    def _stop_loadgen(self) -> None:
        if self.loadgen is not None and self.loadgen.poll() is None:
            self.loadgen.kill()
            self.loadgen.wait()

    def measure(self, rate=None) -> dict:
        """One window at the traffic's rate (or ``rate`` requests/s)."""
        window, seconds, traffic = self.ctx.window, self.ctx.seconds, self.ctx.traffic
        self._start_loadgen(rate)
        start = time.monotonic() + 0.05
        self.loadgen.stdin.write(f"{start!r}\n")
        self.loadgen.stdin.flush()
        t_open = start + traffic["warmup_s"]
        time.sleep(max(0.0, t_open - time.monotonic()))
        probe = host.Probe()
        probe.start()
        window.open()
        cpu0, stats0 = time.process_time(), self.batcher.stats
        time.sleep(max(0.0, t_open + seconds - time.monotonic()))
        cpu1, stats1 = time.process_time(), self.batcher.stats
        window.close()
        watched = probe.stop()
        try:
            out, _ = self.loadgen.communicate(timeout=traffic["drain_s"] + seconds + 60)
        finally:
            self._stop_loadgen()
        if self.loadgen.returncode != 0:
            raise RuntimeError(f"the load generator failed ({self.loadgen.returncode})")
        summary = json.loads(out.strip().splitlines()[-1])
        with np.load(self.answers) as npz:
            self.result = {k: npz[k] for k in npz.files}
        latency = np.where(self.result["ok"], self.result["end"] - self.result["due"], np.inf)
        by_5s = [round(p95(latency[self.result["due"] // 5 == k]) * 1e3, 1)
                 for k in range(int(np.ceil(seconds / 5)))]
        return {"attempted": int(len(latency)), "failed": int((~self.result["ok"]).sum()),
                "window_s": window.seconds, "latency_s": latency.tolist(),
                "server_cpu_s": cpu1 - cpu0,
                "images_served": stats1["images"] - stats0["images"],
                "dispatches": stats1["dispatches"] - stats0["dispatches"],
                "log": [f"load generator: {json.dumps(summary)}",
                        f"p95 ms of each 5 s of the window: {by_5s}",
                        f"host: {json.dumps(dict(host.facts(), **watched))}"]}

    def release(self) -> None:
        self._stop_loadgen()
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)
        self.server = self.batcher = None

    def check(self) -> dict:
        import torch

        from benchmark.reference.clip import ImageTower
        from benchmark.reference.preprocess import clip_preprocess, decode

        n_px = self.ctx.config["image_resolution"]
        canvases = np.stack([clip_preprocess(decode(raw), n_px) for raw in self.jpegs])
        tower = ImageTower(self.state_dict, self.ctx.config["vision_heads"], self.ctx.device)
        ref = torch.nn.functional.normalize(tower(canvases), dim=-1).numpy()
        del tower
        r = self.result
        ok = r["ok"]
        if (r["rows"][ok] != r["counts"][ok]).any():
            return {"feature_err": float("inf")}
        picks = np.split(r["picks"], np.cumsum(r["counts"])[:-1])
        want = np.concatenate([p for p, good in zip(picks, ok) if good] or [np.zeros(0, int)])
        return {"feature_err": compare.feature_err(r["features"], ref[want]) if len(want) else 0.0}
