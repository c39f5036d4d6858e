"""EVA02-CLIP's two towers in plain fp32 PyTorch, read from EVA-CLIP's
state-dict layout, for the tests to hold the port against.

:func:`eva_state_dict` draws a seeded state dict in that layout.

Written from EVA-CLIP (baaivision/EVA ``EVA-CLIP/rei/eva_clip/``):
``eva_vit_model.py`` (``EVAVisionTransformer`` with ``subln``,
``naiveswiglu``, ``rope``, no ``ln_pre``, LayerNorm eps 1e-6),
``rope.py`` (``VisionRotaryEmbeddingFast``) and ``transformer.py``
(``TextTransformer``, ``nn.GELU`` where the model config sets no
``quick_gelu``).  Nothing of the port, of JAX or of the JAX package is
imported; TF32 is turned off for products and convolutions.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

EPS_VISION, EPS_TEXT = 1e-6, 1e-5


def rope_tables(grid: int, pt_grid: int, head_dim: int, theta: float = 10000.0):
    """The closed form, in float64 then rounded to fp32: angle of channel
    pair i of a head's half at position p is p * pt_grid / grid *
    theta^(-2i / (head_dim / 2)); the first half takes the cell's row, the
    second its column; cos and sin of it, (grid^2, head_dim)."""
    half = head_dim // 2
    inv = theta ** (-np.arange(0, half, 2) / half)  # (half / 2,)
    pos = np.arange(grid) * pt_grid / grid
    ang = np.repeat(np.outer(pos, inv), 2, axis=1)  # (grid, half): pairs interleaved
    rows = np.repeat(ang, grid, axis=0)  # cell (r, c) -> row r
    cols = np.tile(ang, (grid, 1))  # cell (r, c) -> column c
    table = np.concatenate([rows, cols], axis=1)
    return (torch.from_numpy(np.cos(table)).float(), torch.from_numpy(np.sin(table)).float())


def _rotate_half(t: torch.Tensor) -> torch.Tensor:
    pairs = t.reshape(*t.shape[:-1], -1, 2)
    return torch.stack((-pairs[..., 1], pairs[..., 0]), dim=-1).reshape(t.shape)


class EvaCLIP:
    """``encode_image(normalized (B, H, W, 3))`` and ``encode_text(ids (B,
    context))``, fp32, on ``device``."""

    def __init__(self, state_dict: Dict[str, torch.Tensor], vision_heads: int, text_heads: int,
                 pt_grid: int, text_act: str = "gelu", device: str = "cpu"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.p = {k: v.to(device=device, dtype=torch.float32) for k, v in state_dict.items()}
        self.vision_heads, self.text_heads = vision_heads, text_heads
        self.act = (F.gelu if text_act == "gelu"
                    else (lambda h: h * torch.sigmoid(1.702 * h)))
        self.vision_layers = len({k.split(".")[2] for k in self.p
                                  if k.startswith("visual.blocks.")})
        self.text_layers = len({k.split(".")[3] for k in self.p
                                if k.startswith("text.transformer.resblocks.")})
        width = self.p["visual.pos_embed"].shape[-1]
        grid = math.isqrt(self.p["visual.pos_embed"].shape[-2] - 1)
        cos, sin = rope_tables(grid, pt_grid, width // vision_heads)
        self.cos, self.sin = cos.to(device), sin.to(device)

    def _ln(self, x, key, eps):
        return F.layer_norm(x, x.shape[-1:], self.p[key + ".weight"], self.p[key + ".bias"], eps)

    def _linear(self, x, key, bias=True):
        y = x @ self.p[key + ".weight"].T
        return y + self.p[key + ".bias"] if bias else y

    def _vision_block(self, x, i):
        b, n, d = x.shape
        h, pre = self.vision_heads, f"visual.blocks.{i}"
        a = self._ln(x, pre + ".norm1", EPS_VISION)
        q = a @ self.p[pre + ".attn.q_proj.weight"].T + self.p[pre + ".attn.q_bias"]
        k = a @ self.p[pre + ".attn.k_proj.weight"].T
        v = a @ self.p[pre + ".attn.v_proj.weight"].T + self.p[pre + ".attn.v_bias"]
        q, k, v = (t.reshape(b, n, h, d // h).transpose(1, 2) for t in (q, k, v))
        # RoPE on the patch tokens; the class token is not turned
        q, k = (torch.cat([t[:, :, :1], t[:, :, 1:] * self.cos + _rotate_half(t[:, :, 1:]) * self.sin],
                          dim=2) for t in (q, k))
        w = torch.softmax(q @ k.transpose(-1, -2) * (d // h) ** -0.5, dim=-1)
        o = (w @ v).transpose(1, 2).reshape(b, n, d)
        o = self._ln(o, pre + ".attn.inner_attn_ln", EPS_VISION)
        x = x + self._linear(o, pre + ".attn.proj")
        a = self._ln(x, pre + ".norm2", EPS_VISION)
        g = F.silu(self._linear(a, pre + ".mlp.w1")) * self._linear(a, pre + ".mlp.w2")
        g = self._ln(g, pre + ".mlp.ffn_ln", EPS_VISION)
        return x + self._linear(g, pre + ".mlp.w3")

    @torch.no_grad()
    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        w = self.p["visual.patch_embed.proj.weight"]
        x = F.conv2d(images.float().permute(0, 3, 1, 2), w, self.p["visual.patch_embed.proj.bias"],
                     stride=w.shape[-1])
        x = x.flatten(2).transpose(1, 2)
        cls = self.p["visual.cls_token"].reshape(1, 1, -1).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.p["visual.pos_embed"].reshape(1, -1, x.shape[-1])
        for i in range(self.vision_layers):
            x = self._vision_block(x, i)
        x = self._ln(x, "visual.norm", EPS_VISION)
        return self._linear(x[:, 0], "visual.head")

    def _text_block(self, x, i, mask):
        b, n, d = x.shape
        h, pre = self.text_heads, f"text.transformer.resblocks.{i}"
        a = self._ln(x, pre + ".ln_1", EPS_TEXT)
        qkv = a @ self.p[pre + ".attn.in_proj_weight"].T + self.p[pre + ".attn.in_proj_bias"]
        q, k, v = (t.reshape(b, n, h, d // h).transpose(1, 2) for t in qkv.split(d, dim=-1))
        s = q @ k.transpose(-1, -2) * (d // h) ** -0.5 + mask
        o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(b, n, d)
        x = x + self._linear(o, pre + ".attn.out_proj")
        m = self.act(self._linear(self._ln(x, pre + ".ln_2", EPS_TEXT), pre + ".mlp.c_fc"))
        return x + self._linear(m, pre + ".mlp.c_proj")

    @torch.no_grad()
    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        tokens = tokens.long().to(self.p["text.positional_embedding"].device)
        x = self.p["text.token_embedding.weight"][tokens] + self.p["text.positional_embedding"]
        n = x.shape[1]
        mask = torch.full((n, n), float("-inf"), device=x.device).triu(1)
        for i in range(self.text_layers):
            x = self._text_block(x, i, mask)
        x = self._ln(x, "text.ln_final", EPS_TEXT)
        return x[torch.arange(x.shape[0]), tokens.argmax(dim=-1)] @ self.p["text.text_projection"]


# -- a seeded state dict in EVA-CLIP's layout -----------------------------------------------

# the tests' tiny geometry
TINY = dict(width=128, heads=2, layers=2, px=56, patch=14, hidden=341, embed=32,
            text_width=64, text_heads=1, text_layers=1, vocab=300, context=16)


def _normal(g, *shape, std=1.0):
    return torch.randn(*shape, generator=g) * std


def eva_state_dict(seed: int = 0, t=TINY, buffers: bool = True, pt_grid: int = 16) -> dict:
    """A synthetic state dict in EVA-CLIP's key layout with seeded weights:
    products at fan_in^-0.5, biases and LayerNorm affine that are not the
    identity, and (``buffers``) the RoPE buffers where EVA-CLIP registers
    them (the tower and each block's attention), of a grid pretrained at
    ``pt_grid`` (EVA02-CLIP's 16)."""
    g = torch.Generator().manual_seed(seed)
    w, h, grid = t["width"], t["hidden"], t["px"] // t["patch"]
    sd = {"visual.patch_embed.proj.weight": _normal(g, w, 3, t["patch"], t["patch"],
                                                     std=(3 * t["patch"] ** 2) ** -0.5),
          "visual.patch_embed.proj.bias": _normal(g, w, std=0.02),
          "visual.cls_token": _normal(g, 1, 1, w, std=0.5),
          "visual.pos_embed": _normal(g, 1, grid * grid + 1, w, std=0.5),
          "visual.head.weight": _normal(g, t["embed"], w, std=w ** -0.5),
          "visual.head.bias": _normal(g, t["embed"], std=0.02),
          "logit_scale": torch.tensor(np.log(1 / 0.07), dtype=torch.float32)}

    def ln(key, n):
        sd[key + ".weight"] = 1 + _normal(g, n, std=0.1)
        sd[key + ".bias"] = _normal(g, n, std=0.05)

    def linear(key, n_out, n_in, bias=True):
        sd[key + ".weight"] = _normal(g, n_out, n_in, std=n_in ** -0.5)
        if bias:
            sd[key + ".bias"] = _normal(g, n_out, std=0.02)

    for i in range(t["layers"]):
        p = f"visual.blocks.{i}"
        ln(p + ".norm1", w)
        for n in "qkv":
            linear(f"{p}.attn.{n}_proj", w, w, bias=False)
        sd[p + ".attn.q_bias"] = _normal(g, w, std=0.02)
        sd[p + ".attn.v_bias"] = _normal(g, w, std=0.02)
        ln(p + ".attn.inner_attn_ln", w)
        linear(p + ".attn.proj", w, w)
        ln(p + ".norm2", w)
        linear(p + ".mlp.w1", h, w)
        linear(p + ".mlp.w2", h, w)
        ln(p + ".mlp.ffn_ln", h)
        linear(p + ".mlp.w3", w, h)
    ln("visual.norm", w)
    tw = t["text_width"]
    sd["text.token_embedding.weight"] = _normal(g, t["vocab"], tw, std=0.02)
    sd["text.positional_embedding"] = _normal(g, t["context"], tw, std=0.01)
    for i in range(t["text_layers"]):
        p = f"text.transformer.resblocks.{i}"
        ln(p + ".ln_1", tw)
        sd[p + ".attn.in_proj_weight"] = _normal(g, 3 * tw, tw, std=tw ** -0.5)
        sd[p + ".attn.in_proj_bias"] = _normal(g, 3 * tw, std=0.02)
        linear(p + ".attn.out_proj", tw, tw)
        ln(p + ".ln_2", tw)
        linear(p + ".mlp.c_fc", 4 * tw, tw)
        linear(p + ".mlp.c_proj", tw, 4 * tw)
    ln("text.ln_final", tw)
    sd["text.text_projection"] = _normal(g, tw, t["embed"], std=tw ** -0.5)
    if buffers:
        cos, sin = rope_tables(grid, pt_grid, w // t["heads"])
        owners = ["visual.rope"] + [f"visual.blocks.{i}.attn.rope" for i in range(t["layers"])]
        for prefix in owners:
            sd[prefix + ".freqs_cos"], sd[prefix + ".freqs_sin"] = cos, sin
    return sd
