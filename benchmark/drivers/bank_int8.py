"""``bank.py``'s bank build with the program on K3, the W8A8 serving block
(``make_encode_fns(..., int8=True)``, the path ``$PROTOCLIP_INT8`` users
build banks on): the same split in host memory, batch, passes and check.

The control is K3 on weights rounded to ``control_bits`` bits per output
channel and back (every matrix of the towers' blocks, the ones K3
quantizes; scale amax / (2^(bits - 1) - 1)), one precision below W8A8.
"""

from __future__ import annotations

import os

import numpy as np

from benchmark import inputs, weights, work
from benchmark.drivers import INPUTS, WEIGHTS
from benchmark.drivers.bank import MAX_PASSES
from benchmark.drivers.bank import Driver as BankDriver


def rounded(sd, bits: int):
    """``sd`` with every matrix of a transformer block rounded to ``bits``
    bits per output channel (its rows) and back to its dtype."""
    import torch

    top = 2 ** (bits - 1) - 1
    out = {}
    for key, value in sd.items():
        if ".resblocks." in key and value.dim() == 2 and key.endswith("weight"):
            w = value.float()
            scale = w.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / top
            value = (torch.round(w / scale).clamp_(-top, top) * scale).to(value.dtype)
        out[key] = value
    return out


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
        self.state_dict = weights.clip_state_dict(cfg, inputs.child_seed(ctx.seed, WEIGHTS),
                                                  ctx.device)
        path = ctx.tmp / "clip.pt"
        torch.save(rounded(self.state_dict, traffic["control_bits"]) if ctx.control
                   else self.state_dict, path)
        n = traffic["classes"] * traffic["shots"]
        self.images = inputs.split_images(inputs.child_seed(ctx.seed, INPUTS), n,
                                          cfg["image_resolution"], ctx.device)
        self.labels = np.repeat(np.arange(traffic["classes"], dtype=np.int32), traffic["shots"])
        run_cfg = Config(backbone=cfg["backbone"], weights_path=str(path),
                         batch_size=traffic["batch_size"], compute_dtype=cfg["compute_dtype"])
        encode_images = make_encode_fns(run_cfg, device=ctx.device, int8=True)[0]
        os.remove(path)
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
        peak_images_per_s = work.PEAK_FLOPS["int8"] / work.image_flops(cfg)
        capacity = min(MAX_PASSES, int(ctx.seconds * peak_images_per_s / n) + 2)
        self.features = np.ones((capacity, *feats.shape), feats.dtype)  # touched: no faults later
        self.labels_ok = np.ones(capacity, bool)
