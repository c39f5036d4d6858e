"""The robot's scene classification: ``ProtoClipClassifier.classify_objects``
on a classifier built as ``cli/ros_node.py::build_classifier`` builds it,
from a deployment config, a checkpoint triple and a split file.

One caller, closed loop: the next scene is classified once the last
answer is in.  A scene holds 1..``max_crops`` crops (each count once in
every cycle of ``max_crops`` scenes, in an order drawn from the seed),
drawn from a seeded pool of crops cut from camera frames.  Every served
top-k answer is held against the plain reference's probabilities of its
crop.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from benchmark import compare, inputs, weights
from benchmark.drivers import INPUTS, TRAFFIC, WEIGHTS


class Driver:
    def __init__(self, ctx):
        import torch

        from protoclip_tpu_torch.cli.ros_node import build_classifier

        self.ctx, cfg, traffic = ctx, ctx.config, ctx.traffic
        self.state_dict = weights.clip_state_dict(cfg, inputs.child_seed(ctx.seed, WEIGHTS),
                                                  ctx.device)
        path = ctx.tmp / "clip.pt"
        torch.save(self.state_dict, path)
        rng = np.random.default_rng(inputs.child_seed(ctx.seed, INPUTS))
        self.deploy = dict(traffic["classifier"], compute_dtype=cfg["compute_dtype"])
        self.triple = inputs.write_triple(rng, ctx.tmp, traffic["classes"], self.deploy["shots"],
                                          cfg["embed_dim"])
        config_path = ctx.tmp / "deployment.yml"  # JSON is YAML
        config_path.write_text(json.dumps(dict(self.deploy, weights_path=str(path))))
        paths = self.triple["paths"]
        # the control is the program's own W8A8 path (K3), which the
        # classifier takes from $PROTOCLIP_INT8
        self._int8_env = os.environ.get("PROTOCLIP_INT8")
        os.environ["PROTOCLIP_INT8"] = "1" if ctx.control else "0"
        self.clf = build_classifier(argparse.Namespace(
            config=str(config_path), splits=paths["split"], memory_bank_v=paths["bank_v"],
            memory_bank_t=paths["bank_t"], adapter_weights=paths["adapter"], device=ctx.device))
        os.remove(path)
        frames = inputs.frames(inputs.child_seed(ctx.seed, INPUTS), traffic["frames"])
        self.crops = inputs.crops(rng, frames,
                                  traffic["crop_pool"], tuple(traffic["crop_side"]))
        self.plan = np.random.default_rng(inputs.child_seed(ctx.seed, TRAFFIC))
        self.class_of = inputs.class_of_name(traffic["classes"])
        infer = self.clf.infer_canvases

        def spanned_infer(canvases):
            with ctx.spans.span("infer"):
                return infer(canvases)

        self.clf.infer_canvases = spanned_infer
        self._cycle = []
        for _ in range(traffic["warmup_scenes"]):  # every call runs the one bucket
            self.clf.classify_objects(self._next_scene())

    def _next_scene(self) -> list:
        if not self._cycle:
            self._cycle = list(self.plan.permutation(self.ctx.traffic["max_crops"]) + 1)
        n = int(self._cycle.pop())
        self._ids = self.plan.integers(0, len(self.crops), n)
        return [self.crops[i] for i in self._ids]

    def measure(self) -> dict:
        window, seconds, spans = self.ctx.window, self.ctx.seconds, self.ctx.spans
        self.answers, scene_s = [], []
        window.open()
        while time.perf_counter() - window.t_open < seconds:
            crops = self._next_scene()
            t0 = time.perf_counter()
            with spans.span("classify"):
                names, probs = self.clf.classify_objects(crops)
            scene_s.append(time.perf_counter() - t0)
            ids = np.asarray([[self.class_of.get(name, -1) for name in row] for row in names])
            self.answers.append((self._ids, ids, np.asarray(probs, np.float64)))
        window.close()
        crops = sum(len(a[0]) for a in self.answers)
        return {"attempted": len(self.answers), "failed": 0, "window_s": window.seconds,
                "scene_s": scene_s, "crops": crops,
                "infer_s": spans.durations("infer", window.t_open, window.t_close)}

    def release(self) -> None:
        self.clf = None
        if self._int8_env is None:
            os.environ.pop("PROTOCLIP_INT8", None)
        else:
            os.environ["PROTOCLIP_INT8"] = self._int8_env

    def check(self) -> dict:
        from benchmark.reference import head
        from benchmark.reference.clip import ImageTower
        from benchmark.reference.preprocess import clip_preprocess
        from PIL import Image

        n_px = self.ctx.config["image_resolution"]
        canvases = np.stack([clip_preprocess(Image.fromarray(c), n_px) for c in self.crops])
        tower = ImageTower(self.state_dict, self.ctx.config["vision_heads"], self.ctx.device)
        feats = tower(canvases)
        del tower
        ref_p = head.probabilities(feats, self.triple["bank_v"], self.triple["bank_t"],
                                   self.triple["adapter"], self.deploy["alpha"],
                                   self.deploy["beta"], self.deploy["shots"])
        k = max(1, self.deploy["top_k"])
        if any(ids.shape != (len(rows), k) or probs.shape != ids.shape or (ids < 0).any()
               for rows, ids, probs in self.answers):
            return {"prob_err": float("inf"), "rank_gap": float("inf")}
        return compare.topk_errs(self.answers, ref_p.numpy())
