"""The bank build of ``bank.py`` with the weight file in memory: the
configuration's seeded state dict is written under ``/dev/shm`` (a RAM
file system), loaded by the program through ``Config.weights_path`` ->
``make_encode_fns`` -> ``load_clip``, and removed, so that a run of a
large backbone writes nothing to disk.  If ``/dev/shm`` cannot hold the
file the run raises; it never falls back to disk.

The configuration's layout picks the weights, the model operations and the
reference: OpenAI's (``weights.py``, ``work.py``, ``reference/clip.py``) or,
where ``vision_block`` is ``eva02``, EVA-CLIP's (``weights_eva.py``,
``work_eva.py``, ``reference/eva.py``).  The window is ``bank.py``'s:
whole passes over the split back to back (``measure``), each feature held
against the reference's after it.

In set-up the program also builds the textual bank, one prompt a class
(seeded token ids, SOT ... EOT) through the same ``make_encode_fns``'s text
encode; ``check`` holds those features against the reference's text tower
too (``text_err``), so that the text tower's own mechanism (the exact GELU
of EVA02-CLIP) is part of ``correct``.

The control: for OpenAI's layout the program's own W8A8 path (K3), as in
``bank.py``; K3 has no EVA02 block, so for EVA-CLIP's the same bf16
program on weights rounded to int8 per output channel and back
(``weights_eva.int8_rounded``).

Counters: ``bank.py``'s, and ``launches``, the kernels launched in the
window by name (``ops.kernels.launch_counts``).
"""

from __future__ import annotations

import shutil
import tempfile
from pathlib import Path

import numpy as np

from benchmark import inputs, weights, weights_eva, work, work_eva
from benchmark.drivers import INPUTS, TRAFFIC, WEIGHTS
from benchmark.drivers.bank import MAX_PASSES, Driver as BankDriver

SHM = Path("/dev/shm")
SHM_SLACK = 64 << 20  # bytes /dev/shm keeps free beyond the file
SOT, EOT = 49406, 49407


def prompts(seed: int, n: int, context: int) -> np.ndarray:
    """``n`` seeded prompts as CLIP token ids (n, context): SOT, 3-16 word
    ids below SOT, EOT (the largest id), zeros."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, context), np.int32)
    for i in range(n):
        words = rng.integers(1, SOT, int(rng.integers(3, min(17, context - 1))))
        row = [SOT, *words, EOT]
        out[i, :len(row)] = row
    return out


def shm_file(nbytes: int) -> Path:
    """A fresh file name under ``/dev/shm`` with room for ``nbytes``."""
    if not SHM.is_dir():
        raise RuntimeError(f"{SHM} is not here: the weight file is kept in memory, never on disk")
    free = shutil.disk_usage(SHM).free
    if free < nbytes + SHM_SLACK:
        raise RuntimeError(f"{SHM} has {free} bytes free, the weight file needs {nbytes}; "
                           "it is kept in memory, never on disk")
    return Path(tempfile.mkdtemp(prefix="benchmark-", dir=SHM)) / "clip.pt"


class Driver(BankDriver):
    def __init__(self, ctx):
        import torch

        from protoclip_tpu_torch.core.config import Config
        from protoclip_tpu_torch.data.loader import ArrayLoader
        from protoclip_tpu_torch.memory.banks import encode_loader
        from protoclip_tpu_torch.ops.kernels import launch_counts
        from protoclip_tpu_torch.train.runner import make_encode_fns

        self.ctx, cfg, traffic = ctx, ctx.config, ctx.traffic
        self._encode_loader, self._launch_counts = encode_loader, launch_counts
        self.eva = cfg.get("vision_block") == "eva02"
        seed = inputs.child_seed(ctx.seed, WEIGHTS)
        self.state_dict = (weights_eva.state_dict(cfg, seed, ctx.device) if self.eva
                           else weights.clip_state_dict(cfg, seed, ctx.device))
        served = (weights_eva.int8_rounded(self.state_dict) if self.eva and ctx.control
                  else self.state_dict)
        path = shm_file(sum(v.numel() * v.element_size() for v in served.values()))
        n = traffic["classes"] * traffic["shots"]
        run_cfg = Config(backbone=cfg["backbone"], weights_path=str(path),
                         batch_size=traffic["batch_size"], compute_dtype=cfg["compute_dtype"])
        try:
            torch.save(served, path)
            del served
            # the OpenAI layout's control is the program's own W8A8 path (K3)
            encode_images, encode_texts, _, _ = make_encode_fns(
                run_cfg, device=ctx.device, int8=ctx.control and not self.eva)
        finally:
            shutil.rmtree(path.parent, ignore_errors=True)
        self.images = inputs.split_images(inputs.child_seed(ctx.seed, INPUTS), n,
                                          cfg["image_resolution"], ctx.device)
        self.labels = np.repeat(np.arange(traffic["classes"], dtype=np.int32), traffic["shots"])
        self.tokens = prompts(inputs.child_seed(ctx.seed, TRAFFIC), traffic["classes"],
                              cfg["context_length"])
        self.text_features = encode_texts(self.tokens).float().cpu().numpy()
        self.encode_rows = []

        def encode(images_u8):
            with ctx.spans.span("encode"):
                out = encode_images(images_u8)
            self.encode_rows.append(len(images_u8))
            return out

        self.encode = encode
        self.loader = ArrayLoader(self.images, self.labels, batch_size=run_cfg.batch_size)
        feats, _ = self._pass()  # warm-up: every shape of the traffic, the short batch too
        self.encode_rows = []
        flops = work_eva.image_flops(cfg) if self.eva else work.image_flops(cfg)
        peak_images_per_s = work.PEAK_FLOPS[cfg["compute_dtype"]] / flops
        capacity = min(MAX_PASSES, int(ctx.seconds * peak_images_per_s / n) + 2)
        self.features = np.ones((capacity, *feats.shape), feats.dtype)  # touched: no faults later
        self.labels_ok = np.ones(capacity, bool)

    def measure(self) -> dict:
        before = self._launch_counts()
        counters = super().measure()
        after = self._launch_counts()
        counters["launches"] = {k: n - before.get(k, 0) for k, n in after.items()
                                if n != before.get(k, 0)}
        return counters

    def check(self) -> dict:
        from benchmark import compare
        from benchmark.reference import eva as ref_eva

        cfg, device = self.ctx.config, self.ctx.device
        text = ref_eva.TextTower(self.state_dict, cfg["transformer_heads"],
                                 cfg.get("text_act", "quick_gelu"), "text." if self.eva else "",
                                 device)
        text_err = compare.feature_err(self.text_features, text(self.tokens).numpy())
        del text
        if not self.eva:
            return dict(super().check(), text_err=text_err)
        tower = ref_eva.EvaImageTower(self.state_dict, cfg["vision_heads"], cfg["rope_pt_grid"],
                                      device)
        ref = tower(self.images).numpy()
        del tower
        if not self.labels_ok[:self.passes].all():
            return {"feature_err": float("inf"), "text_err": text_err}
        return {"feature_err": max(compare.feature_err(feats, ref)
                                   for feats in self.features[:self.passes]),
                "text_err": text_err}
