"""Seeded CLIP weights in OpenAI's state-dict layout, in bf16, the type
the port serves them in (so the reference reads the very values the
program computes with).

The scales start from openai/CLIP ``model.py::initialize_parameters``
(attention ``width**-0.5``, the MLP's ``(2 * width)**-0.5``, the
embeddings' 0.02 and 0.01, ``width**-0.5`` for the class and positional
embeddings and the projections), applied to both towers' blocks.  Two
departures make the activations look like a trained tower's rather than
an initial one's, which is what lets a lower precision show (the
configuration files list them with the rest of what is assumed): the
residual projections (``out_proj``, ``c_proj``) keep ``width**-0.5``
without the init's ``(2 * layers)**-0.5``, so the blocks write to the
residual stream on the scale of their inputs; and every block LayerNorm
scales a fixed 1% of the channels by the configuration's
``outlier_gain``, the outlier features of trained transformers.  Biases are uniform in
+-1/sqrt(fan_in), as PyTorch's default ``Linear`` and ``Conv2d`` draw
them; LayerNorm scales are ``1 + N(0, 0.1**2)`` and shifts
``N(0, 0.02**2)``, so that no affine part is the identity.

Every leaf is ``offset + scale * base``, with ``base`` standard normal or
uniform in [-1, 1).  Leaves that share a draw and a scale lie side by side
in one flat buffer, so the card draws all weights in two calls and scales
them in one call a group; the buffer crosses to the host once.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

Spec = Tuple[str, Tuple[int, ...], str, float, float]  # key, shape, base, scale, offset

LN_SCALE_STD, LN_SHIFT_STD = 0.1, 0.02
OUTLIER_SHARE = 0.01


def _ln(key: str, width: int) -> List[Spec]:
    return [(f"{key}.weight", (width,), "normal", LN_SCALE_STD, 1.0),
            (f"{key}.bias", (width,), "normal", LN_SHIFT_STD, 0.0)]


def _blocks(prefix: str, width: int, layers: int) -> List[Spec]:
    attn_std = proj_std = width ** -0.5
    fc_std = (2 * width) ** -0.5
    out: List[Spec] = []
    for i in range(layers):
        p = f"{prefix}.resblocks.{i}"
        out += [
            (f"{p}.attn.in_proj_weight", (3 * width, width), "normal", attn_std, 0.0),
            (f"{p}.attn.in_proj_bias", (3 * width,), "uniform", width ** -0.5, 0.0),
            (f"{p}.attn.out_proj.weight", (width, width), "normal", proj_std, 0.0),
            (f"{p}.attn.out_proj.bias", (width,), "uniform", width ** -0.5, 0.0),
            *_ln(f"{p}.ln_1", width),
            (f"{p}.mlp.c_fc.weight", (4 * width, width), "normal", fc_std, 0.0),
            (f"{p}.mlp.c_fc.bias", (4 * width,), "uniform", width ** -0.5, 0.0),
            (f"{p}.mlp.c_proj.weight", (width, 4 * width), "normal", proj_std, 0.0),
            (f"{p}.mlp.c_proj.bias", (width,), "uniform", (4 * width) ** -0.5, 0.0),
            *_ln(f"{p}.ln_2", width),
        ]
    return out


def layout(cfg: Dict) -> List[Spec]:
    """Every key of a ViT CLIP state dict with its shape and draw."""
    w, patch, embed = cfg["vision_width"], cfg["vision_patch_size"], cfg["embed_dim"]
    grid = cfg["image_resolution"] // patch
    tw = cfg["transformer_width"]
    return [
        ("visual.class_embedding", (w,), "normal", w ** -0.5, 0.0),
        ("visual.positional_embedding", (grid * grid + 1, w), "normal", w ** -0.5, 0.0),
        ("visual.proj", (w, embed), "normal", w ** -0.5, 0.0),
        ("visual.conv1.weight", (w, 3, patch, patch), "uniform", (3 * patch * patch) ** -0.5, 0.0),
        *_ln("visual.ln_pre", w),
        *_blocks("visual.transformer", w, cfg["vision_layers"]),
        *_ln("visual.ln_post", w),
        ("positional_embedding", (cfg["context_length"], tw), "normal", 0.01, 0.0),
        ("text_projection", (tw, embed), "normal", tw ** -0.5, 0.0),
        ("logit_scale", (), "normal", 0.0, math.log(1 / 0.07)),
        ("token_embedding.weight", (cfg["vocab_size"], tw), "normal", 0.02, 0.0),
        *_blocks("transformer", tw, cfg["transformer_layers"]),
        *_ln("ln_final", tw),
    ]


def clip_state_dict(cfg: Dict, seed: int, device: str) -> Dict:
    """The state dict for ``cfg`` drawn from ``seed`` on ``device``, as
    bf16 views of one host buffer."""
    import numpy as np
    import torch

    specs = layout(cfg)
    numel = [math.prod(shape) for _, shape, _, _, _ in specs]
    order = sorted(range(len(specs)), key=lambda i: specs[i][2:])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    base = {}
    for dist in ("normal", "uniform"):
        n = sum(numel[i] for i in order if specs[i][2] == dist)
        base[dist] = (torch.randn(n, generator=gen, device=device) if dist == "normal"
                      else torch.rand(n, generator=gen, device=device).mul_(2).sub_(1))
    flat = torch.empty(sum(numel), dtype=torch.bfloat16, device=device)
    offsets, pos, used = {}, 0, {"normal": 0, "uniform": 0}
    group_start = 0
    for j, i in enumerate(order):
        offsets[i] = pos
        pos += numel[i]
        last = j + 1 == len(order) or specs[order[j + 1]][2:] != specs[i][2:]
        if last:
            _, _, dist, scale, offset = specs[i]
            n = pos - group_start
            src = base[dist][used[dist]:used[dist] + n]
            flat[group_start:pos] = (src * scale + offset).to(torch.bfloat16)
            used[dist] += n
            group_start = pos
    host = flat.cpu()
    sd = {key: host[offsets[i]:offsets[i] + numel[i]].view(shape)
          for i, (key, shape, _, _, _) in enumerate(specs)}
    rng = np.random.default_rng(int(seed))
    for prefix, width in (("visual.transformer", cfg["vision_width"]),
                          ("transformer", cfg["transformer_width"])):
        channels = torch.from_numpy(rng.choice(width, max(1, round(OUTLIER_SHARE * width)),
                                               replace=False))
        for key, value in sd.items():
            if key.startswith(prefix + ".resblocks.") and key.endswith(("ln_1.weight",
                                                                         "ln_2.weight")):
                value[channels] *= cfg["outlier_gain"]
    return sd
