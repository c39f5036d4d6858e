"""Seeded EVA02-CLIP-bigE weights in EVA-CLIP's post-norm state-dict layout,
in bf16, the type the port serves them in (so the reference reads the very
values the program computes with).

The layout is EVA-CLIP's (baaivision/EVA ``EVA-CLIP/rei/eva_clip``:
``eva_vit_model.py`` with ``postnorm`` and neither ``subln``, ``naiveswiglu``
nor ``rope``, and ``transformer.py``'s ``TextTransformer``):
``visual.patch_embed.proj``, ``visual.cls_token``, ``visual.pos_embed``,
``visual.blocks.N.{norm1, attn.{qkv, q_bias, v_bias, proj}, norm2,
mlp.{fc1, fc2}}``, ``visual.norm``, ``visual.head``, and OpenAI's text tower
under ``text.``.

The scales are ``weights.py``'s and ``weights_eva.py``'s (listed in the
configuration's ``assumed``): products at their fan-in^-0.5, biases uniform
in +-1/sqrt(fan_in), LayerNorm scales 1 + N(0, 0.1^2) and shifts N(0,
0.02^2), and a fixed 1% of the channels of every block's ``norm1`` /
``norm2`` (and the text blocks' ``ln_1`` / ``ln_2``) scaled by the
configuration's ``outlier_gain``.  One departure: ``norm1`` / ``norm2``
scales carry the depth factor (2 * layers)^-0.5 that ``weights.py`` takes
off the residual projections.  In a post-norm block those LayerNorms, not
the projections, set what a block writes to the residual stream, and they
write at their scale whatever their input: at scale 1 the stream grows
many-fold over 128 writes, q . k / sqrt(dh) spreads with it (q and k are
products of the raw stream) and the softmaxes turn nearly one-hot, so that
a rounding anywhere flips some of them (on a 224-wide 64-block copy the
stream grows 57x and the last blocks' mean softmax peak is 0.95; with the
factor 6.5x and 0.12: ``benchmark/tests/test_bench_eva_postnorm.py``).

Five billion values do not fit the card's memory as fp32 draws beside
their bf16 copy, so the draw differs from ``weights.py``'s in its order:
leaves that share a draw and a scale lie side by side in one flat bf16
buffer, and each such group is drawn in chunks of at most :data:`CHUNK`
values straight into it (normal or uniform, then scaled); the buffer
crosses to the host once.

The control's state dict is :func:`fp8_rounded`'s: every matrix rounded to
fp8 e4m3 per output channel and back, the floating-point precision next
below bf16.  (Rounding to int8 per output channel, EVA02's control, reads
only 1.5x / 1.9x the sound runs' highest ``feature_err`` / ``text_err`` on
this tower: PERF.md.)
"""

from __future__ import annotations

import math
from typing import Dict, List

from benchmark.weights import LN_SCALE_STD, LN_SHIFT_STD, OUTLIER_SHARE, Spec, _blocks, _ln

CHUNK = 1 << 28  # values drawn at once: 1 GB of fp32
E4M3_MAX = 448.0  # the largest finite fp8 e4m3 value


def _post_ln(key: str, width: int, depth: float) -> List[Spec]:
    """A post-norm LayerNorm: ``_ln``'s draw with its scale times ``depth``."""
    return [(f"{key}.weight", (width,), "normal", LN_SCALE_STD * depth, depth),
            (f"{key}.bias", (width,), "normal", LN_SHIFT_STD, 0.0)]


def _vision_blocks(width: int, hidden: int, layers: int) -> List[Spec]:
    depth = (2 * layers) ** -0.5
    out: List[Spec] = []
    for i in range(layers):
        p = f"visual.blocks.{i}"
        out += [
            *_post_ln(f"{p}.norm1", width, depth),
            (f"{p}.attn.qkv.weight", (3 * width, width), "normal", width ** -0.5, 0.0),
            (f"{p}.attn.q_bias", (width,), "uniform", width ** -0.5, 0.0),
            (f"{p}.attn.v_bias", (width,), "uniform", width ** -0.5, 0.0),
            (f"{p}.attn.proj.weight", (width, width), "normal", width ** -0.5, 0.0),
            (f"{p}.attn.proj.bias", (width,), "uniform", width ** -0.5, 0.0),
            *_post_ln(f"{p}.norm2", width, depth),
            (f"{p}.mlp.fc1.weight", (hidden, width), "normal", width ** -0.5, 0.0),
            (f"{p}.mlp.fc1.bias", (hidden,), "uniform", width ** -0.5, 0.0),
            (f"{p}.mlp.fc2.weight", (width, hidden), "normal", hidden ** -0.5, 0.0),
            (f"{p}.mlp.fc2.bias", (width,), "uniform", hidden ** -0.5, 0.0),
        ]
    return out


def layout(cfg: Dict) -> List[Spec]:
    """Every key of a post-norm EVA02-CLIP state dict with its shape and draw."""
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
    views of one host buffer."""
    import numpy as np
    import torch

    specs = layout(cfg)
    numel = [math.prod(shape) for _, shape, _, _, _ in specs]
    order = sorted(range(len(specs)), key=lambda i: specs[i][2:])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(sum(numel), dtype=torch.bfloat16, device=device)
    offsets, pos, group_start = {}, 0, 0
    for j, i in enumerate(order):
        offsets[i] = pos
        pos += numel[i]
        if j + 1 == len(order) or specs[order[j + 1]][2:] != specs[i][2:]:
            _, _, dist, scale, offset = specs[i]
            for start in range(group_start, pos, CHUNK):
                n = min(CHUNK, pos - start)
                base = (torch.randn(n, generator=gen, device=device) if dist == "normal"
                        else torch.rand(n, generator=gen, device=device).mul_(2).sub_(1))
                flat[start:start + n] = base.mul_(scale).add_(offset).to(torch.bfloat16)
                del base
            group_start = pos
    host = flat.cpu()
    del flat
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


def fp8_rounded(sd: Dict, device: str) -> Dict:
    """Every matrix of ``sd`` (a weight of two or more axes other than the
    token embedding, as ``weights_eva.int8_rounded`` picks them) scaled per
    output channel to amax :data:`E4M3_MAX`, rounded to fp8 e4m3 (3
    mantissa bits, to nearest even) and back to its dtype, one matrix at a
    time on ``device``: the bf16 program on fp8 weights, the control."""
    import torch

    out = {}
    for key, value in sd.items():
        if value.dim() >= 2 and key.endswith("weight") and key != "text.token_embedding.weight":
            w = value.to(device, torch.float32)
            scale = w.abs().amax(dim=tuple(range(1, w.dim())), keepdim=True).clamp_min(
                1e-12) / E4M3_MAX
            codes = (w / scale).clamp_(-E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn)
            value = (codes.float() * scale).to(value.dtype).to(value.device)
        out[key] = value
    return out
