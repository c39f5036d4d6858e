"""The bank build: ``memory/banks.py::encode_loader`` over the runner's
image encode (``train/runner.py::make_encode_fns``) and an
``ArrayLoader`` of a few-shot support split held in host memory.

The window runs whole passes over the split back to back, as the
runner's ``augment_epoch`` passes do; the last batch of each pass is the
loader's zero-padded one.  Every feature of every pass is copied into a
buffer made and touched in set-up, sized for the most passes the card's
peak could finish in the window (at most ``MAX_PASSES``; past that it
doubles), so the window allocates nothing of the benchmark's own; after it, each is held against the plain reference's
features of the same image.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from benchmark import compare, host, inputs, weights, work
from benchmark.drivers import INPUTS, WEIGHTS

MAX_PASSES = 1024


class _SpannedLoader:
    """The loader, with a ``loader`` span around each batch it yields."""

    def __init__(self, loader, spans):
        self.loader, self.spans = loader, spans

    def __iter__(self):
        it = iter(self.loader)
        while True:
            with self.spans.span("loader"):
                batch = next(it, None)
            if batch is None:
                return
            yield batch


class Driver:
    def __init__(self, ctx):
        import torch

        from protoclip_tpu_torch.core.config import Config
        from protoclip_tpu_torch.data.loader import ArrayLoader
        from protoclip_tpu_torch.memory.banks import encode_loader
        from protoclip_tpu_torch.ops.kernels import launch_counts
        from protoclip_tpu_torch.train.runner import make_encode_fns

        self.ctx, cfg, traffic = ctx, ctx.config, ctx.traffic
        self._encode_loader, self._launch_counts = encode_loader, launch_counts
        self.state_dict = weights.clip_state_dict(cfg, inputs.child_seed(ctx.seed, WEIGHTS),
                                                  ctx.device)
        path = ctx.tmp / "clip.pt"
        torch.save(self.state_dict, path)
        n = traffic["classes"] * traffic["shots"]
        self.images = inputs.split_images(inputs.child_seed(ctx.seed, INPUTS), n,
                                          cfg["image_resolution"], ctx.device)
        self.labels = np.repeat(np.arange(traffic["classes"], dtype=np.int32), traffic["shots"])
        run_cfg = Config(backbone=cfg["backbone"], weights_path=str(path),
                         batch_size=traffic["batch_size"], compute_dtype=cfg["compute_dtype"])
        # the control is the program's own W8A8 path (K3)
        encode_images = make_encode_fns(run_cfg, device=ctx.device, int8=ctx.control)[0]
        os.remove(path)
        self.encode_rows = []

        def encode(images_u8):
            with ctx.spans.span("encode"):
                out = encode_images(images_u8)
            self.encode_rows.append(len(images_u8))
            return out

        self.encode = encode
        self.loader = ArrayLoader(self.images, self.labels, batch_size=run_cfg.batch_size)
        feats, _ = self._pass()  # warm-up: every shape of the traffic, the padded batch too
        self.encode_rows = []
        peak_images_per_s = work.PEAK_FLOPS[cfg["compute_dtype"]] / work.image_flops(cfg)
        capacity = min(MAX_PASSES, int(ctx.seconds * peak_images_per_s / n) + 2)
        self.features = np.ones((capacity, *feats.shape), feats.dtype)  # touched: no faults later
        self.labels_ok = np.ones(capacity, bool)

    def _pass(self):
        with self.ctx.spans.span("encode_loader"):
            return self._encode_loader(self.encode, _SpannedLoader(self.loader, self.ctx.spans))

    def measure(self) -> dict:
        window, seconds = self.ctx.window, self.ctx.seconds
        launches = self._launch_counts()
        probe = host.Probe()
        probe.start()
        self.passes = 0
        window.open()
        while True:
            feats, labels = self._pass()
            if self.passes == len(self.features):
                self.features = np.concatenate([self.features, np.ones_like(self.features)])
                self.labels_ok = np.concatenate([self.labels_ok, self.labels_ok])
            self.features[self.passes] = feats
            self.labels_ok[self.passes] = np.array_equal(labels, self.labels)
            self.passes += 1
            if time.perf_counter() - window.t_open >= seconds:
                break
        window.close()
        watched = probe.stop()
        after = self._launch_counts()
        launched = {k: n - launches.get(k, 0) for k, n in after.items() if n != launches.get(k, 0)}
        valid = self.passes * len(self.images)
        return {"attempted": valid, "failed": 0, "window_s": window.seconds,
                "valid_images": valid, "encode_rows": list(self.encode_rows),
                "log": [f"kernel launches in the window: {launched}",
                        f"host: {json.dumps(dict(host.facts(), **watched))}"]}

    def release(self) -> None:
        self.encode = self.loader = None

    def check(self) -> dict:
        from benchmark.reference.clip import ImageTower

        tower = ImageTower(self.state_dict, self.ctx.config["vision_heads"], self.ctx.device)
        ref = tower(self.images).numpy()
        del tower
        if not self.labels_ok[:self.passes].all():
            return {"feature_err": float("inf")}
        return {"feature_err": max(compare.feature_err(feats, ref)
                                   for feats in self.features[:self.passes])}
