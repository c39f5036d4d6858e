"""EVA02-CLIP-bigE's two towers in plain fp32 PyTorch, read from EVA-CLIP's
post-norm state-dict layout, for the tests to hold the port against.

:func:`postnorm_state_dict` draws a seeded state dict in that layout.

Written from EVA-CLIP (baaivision/EVA ``EVA-CLIP/rei/eva_clip/``):
``eva_vit_model.py`` (``EVAVisionTransformer`` with ``postnorm``: each
``Block`` computes x + norm1(attn(x)), then x + norm2(mlp(x)); ``Attention``
without ``subln`` or ``rope``: one ``qkv`` product with the bias
[q_bias, 0, v_bias], scale head_dim^-0.5, no inner LayerNorm; ``Mlp``:
``fc1``, ``nn.GELU``, ``fc2``, no ``ffn_ln``; no ``ln_pre``; LayerNorm eps
1e-6; ``norm`` over the sequence, the class token, ``head``) and
``transformer.py`` (``TextTransformer``, ``nn.GELU`` where the model config
sets no ``quick_gelu``).  Nothing of the port, of JAX or of the JAX package
is imported; TF32 is turned off for products and convolutions.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

EPS_VISION, EPS_TEXT = 1e-6, 1e-5

# the tests' tiny geometry: 2 heads of 32, an MLP of 480
TINY = dict(width=64, heads=2, layers=2, px=56, patch=14, hidden=480, embed=32,
            text_width=64, text_heads=1, text_layers=2, vocab=300, context=16)


class EvaPostnormCLIP:
    """``encode_image(normalized (B, H, W, 3))`` and ``encode_text(ids (B,
    context))``, fp32, on ``device``."""

    def __init__(self, state_dict, vision_heads: int, text_heads: int, text_act: str = "gelu",
                 device: str = "cpu"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.p = {k: v.to(device=device, dtype=torch.float32) for k, v in state_dict.items()}
        self.vision_heads, self.text_heads = vision_heads, text_heads
        self.act = F.gelu if text_act == "gelu" else (lambda h: h * torch.sigmoid(1.702 * h))
        self.vision_layers = len({k.split(".")[2] for k in self.p
                                  if k.startswith("visual.blocks.")})
        self.text_layers = len({k.split(".")[3] for k in self.p
                                if k.startswith("text.transformer.resblocks.")})

    def _ln(self, x, key, eps):
        return F.layer_norm(x, x.shape[-1:], self.p[key + ".weight"], self.p[key + ".bias"], eps)

    def _linear(self, x, key):
        return x @ self.p[key + ".weight"].T + self.p[key + ".bias"]

    def _attention(self, x, pre):
        b, n, d = x.shape
        h = self.vision_heads
        q_bias, v_bias = self.p[pre + ".q_bias"], self.p[pre + ".v_bias"]
        bias = torch.cat([q_bias, torch.zeros_like(v_bias), v_bias])
        qkv = F.linear(x, self.p[pre + ".qkv.weight"], bias)
        q, k, v = qkv.reshape(b, n, 3, h, -1).permute(2, 0, 3, 1, 4)
        w = torch.softmax((q * (d // h) ** -0.5) @ k.transpose(-1, -2), dim=-1)
        return self._linear((w @ v).transpose(1, 2).reshape(b, n, d), pre + ".proj")

    def _vision_block(self, x, i):
        pre = f"visual.blocks.{i}"
        x = x + self._ln(self._attention(x, pre + ".attn"), pre + ".norm1", EPS_VISION)
        m = self._linear(F.gelu(self._linear(x, pre + ".mlp.fc1")), pre + ".mlp.fc2")
        return x + self._ln(m, pre + ".norm2", EPS_VISION)

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


def _normal(g, *shape, std=1.0):
    return torch.randn(*shape, generator=g) * std


def postnorm_state_dict(seed: int = 0, t=TINY) -> dict:
    """A synthetic state dict in EVA-CLIP's post-norm key layout with seeded
    weights: products at fan_in^-0.5, biases and LayerNorm affine that are
    not the identity, q and v biases and no k bias."""
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

    def linear(key, n_out, n_in):
        sd[key + ".weight"] = _normal(g, n_out, n_in, std=n_in ** -0.5)
        sd[key + ".bias"] = _normal(g, n_out, std=0.02)

    for i in range(t["layers"]):
        p = f"visual.blocks.{i}"
        ln(p + ".norm1", w)
        sd[p + ".attn.qkv.weight"] = _normal(g, 3 * w, w, std=w ** -0.5)
        sd[p + ".attn.q_bias"] = _normal(g, w, std=0.02)
        sd[p + ".attn.v_bias"] = _normal(g, w, std=0.02)
        linear(p + ".attn.proj", w, w)
        ln(p + ".norm2", w)
        linear(p + ".mlp.fc1", h, w)
        linear(p + ".mlp.fc2", w, h)
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
    return sd
