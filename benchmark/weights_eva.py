"""Seeded EVA02-CLIP weights in EVA-CLIP's state-dict layout, in bf16, the
type the port serves them in (so the reference reads the very values the
program computes with).

The layout is EVA-CLIP's (baaivision/EVA ``EVA-CLIP/rei/eva_clip``:
``eva_vit_model.py`` with ``subln``, ``naiveswiglu`` and ``rope``, and
``transformer.py``'s ``TextTransformer``): ``visual.patch_embed.proj``,
``visual.cls_token``, ``visual.pos_embed``, ``visual.blocks.N.{norm1,
attn.{q,k,v}_proj, attn.{q,v}_bias, attn.inner_attn_ln, attn.proj, norm2,
mlp.{w1, w2, ffn_ln, w3}}``, ``visual.norm``, ``visual.head``, and
OpenAI's text tower under ``text.``.  No RoPE buffers: the program computes
its tables.

The draws follow ``weights.py`` (the same departures, listed in the
configuration's ``assumed``): products at their fan-in^-0.5 (so the
residual projections, ``attn.proj`` and ``mlp.w3``, carry no depth
factor), biases uniform in +-1/sqrt(fan_in), LayerNorm scales 1 + N(0,
0.1^2) and shifts N(0, 0.02^2), and a fixed 1% of the channels of every
block's ``norm1`` / ``norm2`` (and the text blocks' ``ln_1`` / ``ln_2``)
scaled by the configuration's ``outlier_gain``.  The sub-LNs
(``inner_attn_ln``, ``ffn_ln``) keep no outliers: they normalise inside a
branch.

:func:`int8_rounded` is the control's state dict: every matrix rounded to
int8 per output channel and back, one precision below bf16.
"""

from __future__ import annotations

import math
from typing import Dict, List

from benchmark.weights import OUTLIER_SHARE, Spec, _blocks, _ln


def _vision_blocks(width: int, hidden: int, layers: int) -> List[Spec]:
    out: List[Spec] = []
    for i in range(layers):
        p = f"visual.blocks.{i}"
        out += [
            *_ln(f"{p}.norm1", width),
            *[(f"{p}.attn.{n}_proj.weight", (width, width), "normal", width ** -0.5, 0.0)
              for n in "qkv"],
            (f"{p}.attn.q_bias", (width,), "uniform", width ** -0.5, 0.0),
            (f"{p}.attn.v_bias", (width,), "uniform", width ** -0.5, 0.0),
            *_ln(f"{p}.attn.inner_attn_ln", width),
            (f"{p}.attn.proj.weight", (width, width), "normal", width ** -0.5, 0.0),
            (f"{p}.attn.proj.bias", (width,), "uniform", width ** -0.5, 0.0),
            *_ln(f"{p}.norm2", width),
            (f"{p}.mlp.w1.weight", (hidden, width), "normal", width ** -0.5, 0.0),
            (f"{p}.mlp.w1.bias", (hidden,), "uniform", width ** -0.5, 0.0),
            (f"{p}.mlp.w2.weight", (hidden, width), "normal", width ** -0.5, 0.0),
            (f"{p}.mlp.w2.bias", (hidden,), "uniform", width ** -0.5, 0.0),
            *_ln(f"{p}.mlp.ffn_ln", hidden),
            (f"{p}.mlp.w3.weight", (width, hidden), "normal", hidden ** -0.5, 0.0),
            (f"{p}.mlp.w3.bias", (width,), "uniform", hidden ** -0.5, 0.0),
        ]
    return out


def layout(cfg: Dict) -> List[Spec]:
    """Every key of an EVA02-CLIP state dict with its shape and draw."""
    w, patch, embed = cfg["vision_width"], cfg["vision_patch_size"], cfg["embed_dim"]
    grid = cfg["image_resolution"] // patch
    tw = cfg["transformer_width"]
    fan = 3 * patch * patch
    return [
        ("visual.cls_token", (1, 1, w), "normal", w ** -0.5, 0.0),
        ("visual.pos_embed", (1, grid * grid + 1, w), "normal", w ** -0.5, 0.0),
        ("visual.patch_embed.proj.weight", (w, 3, patch, patch), "uniform", fan ** -0.5, 0.0),
        ("visual.patch_embed.proj.bias", (w,), "uniform", fan ** -0.5, 0.0),
        *_vision_blocks(w, cfg["vision_mlp_width"], cfg["vision_layers"]),
        *_ln("visual.norm", w),
        ("visual.head.weight", (embed, w), "normal", w ** -0.5, 0.0),
        ("visual.head.bias", (embed,), "uniform", w ** -0.5, 0.0),
        ("text.positional_embedding", (cfg["context_length"], tw), "normal", 0.01, 0.0),
        ("text.text_projection", (tw, embed), "normal", tw ** -0.5, 0.0),
        ("logit_scale", (), "normal", 0.0, math.log(1 / 0.07)),
        ("text.token_embedding.weight", (cfg["vocab_size"], tw), "normal", 0.02, 0.0),
        *_blocks("text.transformer", tw, cfg["transformer_layers"]),
        *_ln("text.ln_final", tw),
    ]


def state_dict(cfg: Dict, seed: int, device: str) -> Dict:
    """The state dict for ``cfg`` drawn from ``seed`` on ``device``, as bf16
    views of one host buffer: the same draw as ``weights.clip_state_dict``
    (leaves that share a draw and a scale in one flat buffer, two calls of
    the generator, one scaling a group)."""
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
    offsets, pos, used, group_start = {}, 0, {"normal": 0, "uniform": 0}, 0
    for j, i in enumerate(order):
        offsets[i] = pos
        pos += numel[i]
        if j + 1 == len(order) or specs[order[j + 1]][2:] != specs[i][2:]:
            _, _, dist, scale, offset = specs[i]
            n = pos - group_start
            flat[group_start:pos] = (base[dist][used[dist]:used[dist] + n] * scale
                                     + offset).to(torch.bfloat16)
            used[dist] += n
            group_start = pos
    host = flat.cpu()
    sd = {key: host[offsets[i]:offsets[i] + numel[i]].view(shape)
          for i, (key, shape, _, _, _) in enumerate(specs)}
    rng = np.random.default_rng(int(seed))
    for prefix, width, norms in (("visual.blocks.", cfg["vision_width"], ("norm1", "norm2")),
                                 ("text.transformer.resblocks.", cfg["transformer_width"],
                                  ("ln_1", "ln_2"))):
        channels = torch.from_numpy(rng.choice(width, max(1, round(OUTLIER_SHARE * width)),
                                               replace=False))
        for key, value in sd.items():
            if key.startswith(prefix) and key.endswith(tuple(f".{n}.weight" for n in norms)):
                value[channels] *= cfg["outlier_gain"]
    return sd


def int8_rounded(sd: Dict) -> Dict:
    """Every matrix of ``sd`` (a weight of two or more axes other than the
    token embedding) rounded to int8 per output channel, scale amax / 127, and
    back to its dtype: the bf16 program on int8 weights, the control of a
    cell whose program has no W8A8 path."""
    import torch

    out = {}
    for key, value in sd.items():
        if value.dim() >= 2 and key.endswith("weight") and key != "text.token_embedding.weight":
            w = value.float()
            scale = w.abs().amax(dim=tuple(range(1, w.dim())), keepdim=True).clamp_min(1e-12) / 127
            value = (torch.round(w / scale).clamp_(-127, 127) * scale).to(value.dtype)
        out[key] = value
    return out
