"""``bank_shm.py``'s bank build on EVA02-CLIP-bigE's post-norm tower: the
split (198 x 16 seeded images of 224 px in host memory) through
``encode_loader`` at batch 1024, passes back to back, the last 96 rows at
their own size; the bf16 weight file (10.1 GB) in ``/dev/shm``, loaded by
the program through ``Config.weights_path`` -> ``make_encode_fns`` ->
``load_clip``; the textual bank's 198 seeded prompts encoded in set-up.

Weights from ``weights_eva_postnorm.py``, model operations from
``work_eva_postnorm.py``, the reference ``reference/eva_postnorm.py`` (and
``reference/eva.py``'s text tower).  The control is the same bf16 program
on weights rounded to fp8 e4m3 per output channel and back
(``weights_eva_postnorm.fp8_rounded``).

``check`` holds a fixed set of rows of every pass against the reference
(``feature_err``): every ``check_every``-th row of each full batch and every
row of the short batch (480 of the 3168 images at 8: 1.1 PFLOP in fp32, not
7.2), a cut of the reference's cost only, since every pass encodes every
row alike; and every prompt's features against the text tower's
(``text_err``).  A program without the configuration's backbone fails at
once, before any weight is drawn.

Counters: ``bank_shm.py``'s (``bank.py``'s and the kernels ``launches``);
the log also gives the seconds of each step of set-up.
"""

from __future__ import annotations

import shutil
import time

import numpy as np

from benchmark import compare, inputs, weights_eva_postnorm, work, work_eva_postnorm
from benchmark.drivers import INPUTS, TRAFFIC, WEIGHTS
from benchmark.drivers.bank import MAX_PASSES
from benchmark.drivers.bank_shm import Driver as ShmDriver
from benchmark.drivers.bank_shm import prompts, shm_file


def checked_rows(n: int, batch: int, every: int) -> np.ndarray:
    """Every ``every``-th row of each full batch of a pass over ``n`` rows,
    and every row of its short last batch."""
    full = n // batch * batch
    return np.concatenate([np.arange(0, full, every), np.arange(full, n)])


class Driver(ShmDriver):
    def __init__(self, ctx):
        from protoclip_tpu_torch.core.config import Config
        from protoclip_tpu_torch.data.loader import ArrayLoader
        from protoclip_tpu_torch.memory.banks import encode_loader
        from protoclip_tpu_torch.models.clip import backbone_config
        from protoclip_tpu_torch.ops.kernels import launch_counts
        from protoclip_tpu_torch.train.runner import make_encode_fns

        self.ctx, cfg, traffic = ctx, ctx.config, ctx.traffic
        known = backbone_config(cfg["backbone"])
        if known is None or known.vision_block != cfg["vision_block"]:
            raise RuntimeError(f"the program has no {cfg['backbone']} backbone with "
                               f"{cfg['vision_block']} blocks")
        self._encode_loader, self._launch_counts = encode_loader, launch_counts
        self.marks = [("start", time.perf_counter())]
        self.state_dict = weights_eva_postnorm.state_dict(
            cfg, inputs.child_seed(ctx.seed, WEIGHTS), ctx.device)
        served = (weights_eva_postnorm.fp8_rounded(self.state_dict, ctx.device) if ctx.control
                  else self.state_dict)
        self.marks.append(("draw", time.perf_counter()))
        path = shm_file(sum(v.numel() * v.element_size() for v in served.values()))
        n = traffic["classes"] * traffic["shots"]
        run_cfg = Config(backbone=cfg["backbone"], weights_path=str(path),
                         batch_size=traffic["batch_size"], compute_dtype=cfg["compute_dtype"])
        try:
            import torch

            torch.save(served, path)
            del served
            self.marks.append(("save", time.perf_counter()))
            encode_images, encode_texts, _, _ = make_encode_fns(run_cfg, device=ctx.device,
                                                                int8=False)
            self.marks.append(("load", time.perf_counter()))
        finally:
            shutil.rmtree(path.parent, ignore_errors=True)
        self.images = inputs.split_images(inputs.child_seed(ctx.seed, INPUTS), n,
                                          cfg["image_resolution"], ctx.device)
        self.labels = np.repeat(np.arange(traffic["classes"], dtype=np.int32), traffic["shots"])
        self.rows = checked_rows(n, traffic["batch_size"], traffic["check_every"])
        self.tokens = prompts(inputs.child_seed(ctx.seed, TRAFFIC), traffic["classes"],
                              cfg["context_length"])
        self.text_features = encode_texts(self.tokens).float().cpu().numpy()
        self.marks.append(("inputs_and_text", time.perf_counter()))
        self.encode_rows = []

        def encode(images_u8):
            with ctx.spans.span("encode"):
                out = encode_images(images_u8)
            self.encode_rows.append(len(images_u8))
            return out

        self.encode = encode
        self.loader = ArrayLoader(self.images, self.labels, batch_size=run_cfg.batch_size)
        feats, _ = self._pass()  # warm-up: every shape of the traffic, the short batch too
        self.marks.append(("warm_up", time.perf_counter()))
        self.encode_rows = []
        peak_images_per_s = work.PEAK_FLOPS[cfg["compute_dtype"]] / work_eva_postnorm.image_flops(
            cfg)
        capacity = min(MAX_PASSES, int(ctx.seconds * peak_images_per_s / n) + 2)
        self.features = np.ones((capacity, *feats.shape), feats.dtype)  # touched: no faults later
        self.labels_ok = np.ones(capacity, bool)

    def measure(self) -> dict:
        counters = super().measure()
        steps = ", ".join(f"{name} {t - t_before:.2f}" for (_, t_before), (name, t)
                          in zip(self.marks, self.marks[1:]))
        counters["log"] = [*counters.get("log", []), f"set-up steps (s): {steps}"]
        return counters

    def check(self) -> dict:
        from benchmark.reference.eva import TextTower
        from benchmark.reference.eva_postnorm import PostnormImageTower

        cfg, device = self.ctx.config, self.ctx.device
        text = TextTower(self.state_dict, cfg["transformer_heads"], cfg["text_act"], "text.",
                         device)
        text_err = compare.feature_err(self.text_features, text(self.tokens).numpy())
        del text
        tower = PostnormImageTower(self.state_dict, cfg["vision_heads"], device)
        ref = tower(self.images[self.rows]).numpy()
        del tower
        if not self.labels_ok[:self.passes].all():
            return {"feature_err": float("inf"), "text_err": text_err}
        return {"feature_err": max(compare.feature_err(feats[self.rows], ref)
                                   for feats in self.features[:self.passes]),
                "text_err": text_err}
