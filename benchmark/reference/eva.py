"""EVA02-CLIP's image tower, and a CLIP text tower of either activation, in
plain fp32 PyTorch over their state-dict layouts, and ``ToTensor +
Normalize``.

Written from EVA-CLIP (baaivision/EVA ``EVA-CLIP/rei/eva_clip``):
``eva_vit_model.py`` (``EVAVisionTransformer`` with ``subln``,
``naiveswiglu`` and ``rope``: no ``ln_pre``, LayerNorm eps 1e-6, q and v
biases and no k bias, RoPE on q and k of the patch tokens, a LayerNorm on
the attention output and on the SwiGLU hidden), ``rope.py``
(``VisionRotaryEmbeddingFast``) and ``transformer.py`` (``TextTransformer``:
OpenAI's text tower, with ``nn.GELU`` where the model config sets no
``quick_gelu``).  The products run in full fp32 (TF32 off), in blocks.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.clip import MEAN, STD

EPS_VISION, EPS_TEXT = 1e-6, 1e-5
THETA = 10000.0


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rope_tables(grid: int, pt_grid: int, head_dim: int):
    """(grid^2, head_dim) fp32 cos and sin: a head's first half turns with
    the cell's row, its second with its column; pair i of a half at
    position p by p * pt_grid / grid * THETA^(-2i / (head_dim / 2)), each
    angle on two neighbouring channels; worked in float64."""
    half = head_dim // 2
    angles = np.outer(np.arange(grid) * pt_grid / grid, THETA ** (-np.arange(0, half, 2) / half))
    angles = np.repeat(angles, 2, axis=1)
    r, c = np.divmod(np.arange(grid * grid), grid)
    table = np.concatenate([angles[r], angles[c]], axis=1)
    return torch.from_numpy(np.cos(table)).float(), torch.from_numpy(np.sin(table)).float()


def _turn(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """t cos + rotate_half(t) sin; rotate_half takes the interleaved pair
    (t0, t1) to (-t1, t0)."""
    pairs = t.reshape(*t.shape[:-1], -1, 2)
    half = torch.stack((-pairs[..., 1], pairs[..., 0]), dim=-1).reshape(t.shape)
    return t * cos + half * sin


class _Tower:
    def __init__(self, state_dict: Dict[str, torch.Tensor], prefix: str, device: str,
                 block: int):
        _no_tf32()
        self.p = {k[len(prefix):]: v.to(device=device, dtype=torch.float32)
                  for k, v in state_dict.items()
                  if k.startswith(prefix) and (prefix or not k.startswith("visual."))}
        self.device, self.block = device, block

    def _ln(self, x, key, eps):
        return F.layer_norm(x, x.shape[-1:], self.p[key + ".weight"], self.p[key + ".bias"], eps)

    def _linear(self, x, key):
        return x @ self.p[key + ".weight"].T + self.p[key + ".bias"]


class EvaImageTower(_Tower):
    """``__call__(uint8 (B, H, W, 3)) -> fp32 (B, embed_dim)``, computed in
    blocks of ``block`` images."""

    def __init__(self, state_dict: Dict[str, torch.Tensor], heads: int, pt_grid: int,
                 device: str, block: int = 64):
        super().__init__(state_dict, "visual.", device, block)
        self.heads = heads
        self.layers = len({k.split(".")[1] for k in self.p if k.startswith("blocks.")})
        width = self.p["pos_embed"].shape[-1]
        grid = math.isqrt(self.p["pos_embed"].shape[-2] - 1)
        cos, sin = rope_tables(grid, pt_grid, width // heads)
        self.cos, self.sin = cos.to(device), sin.to(device)
        self.mean = torch.tensor(MEAN, device=device)
        self.std = torch.tensor(STD, device=device)

    def _block(self, x, i):
        b, n, d = x.shape
        h, pre = self.heads, f"blocks.{i}"
        a = self._ln(x, pre + ".norm1", EPS_VISION)
        q = a @ self.p[pre + ".attn.q_proj.weight"].T + self.p[pre + ".attn.q_bias"]
        k = a @ self.p[pre + ".attn.k_proj.weight"].T
        v = a @ self.p[pre + ".attn.v_proj.weight"].T + self.p[pre + ".attn.v_bias"]
        q, k, v = (t.reshape(b, n, h, d // h).transpose(1, 2) for t in (q, k, v))
        q = torch.cat([q[:, :, :1], _turn(q[:, :, 1:], self.cos, self.sin)], dim=2)
        k = torch.cat([k[:, :, :1], _turn(k[:, :, 1:], self.cos, self.sin)], dim=2)
        w = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d // h), dim=-1)
        o = (w @ v).transpose(1, 2).reshape(b, n, d)
        x = x + self._linear(self._ln(o, pre + ".attn.inner_attn_ln", EPS_VISION),
                             pre + ".attn.proj")
        a = self._ln(x, pre + ".norm2", EPS_VISION)
        g = F.silu(self._linear(a, pre + ".mlp.w1")) * self._linear(a, pre + ".mlp.w2")
        return x + self._linear(self._ln(g, pre + ".mlp.ffn_ln", EPS_VISION), pre + ".mlp.w3")

    @torch.no_grad()
    def _encode(self, images_u8: torch.Tensor) -> torch.Tensor:
        x = (images_u8.to(self.device).float() / 255.0 - self.mean) / self.std
        w = self.p["patch_embed.proj.weight"]
        x = F.conv2d(x.permute(0, 3, 1, 2), w, self.p["patch_embed.proj.bias"], stride=w.shape[-1])
        x = x.flatten(2).transpose(1, 2)
        cls = self.p["cls_token"].reshape(1, 1, -1).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.p["pos_embed"].reshape(1, -1, x.shape[-1])
        for i in range(self.layers):
            x = self._block(x, i)
        return self._linear(self._ln(x, "norm", EPS_VISION)[:, 0], "head")

    def __call__(self, images_u8) -> torch.Tensor:
        images_u8 = torch.as_tensor(images_u8)
        return torch.cat([self._encode(images_u8[i:i + self.block]).cpu()
                          for i in range(0, len(images_u8), self.block)])


class TextTower(_Tower):
    """CLIP's text tower (OpenAI's ``model.py``, EVA-CLIP's
    ``TextTransformer``) under ``prefix`` (``""`` for OpenAI's layout,
    ``"text."`` for EVA-CLIP's): ``__call__(ids (B, context)) -> fp32 (B,
    embed_dim)``, the feature at the EOT (largest) id.  ``act``:
    ``quick_gelu`` or ``gelu`` (erf)."""

    def __init__(self, state_dict: Dict[str, torch.Tensor], heads: int, act: str, prefix: str,
                 device: str, block: int = 256):
        super().__init__(state_dict, prefix, device, block)
        self.heads = heads
        self.act = {"gelu": F.gelu, "quick_gelu": lambda t: t * torch.sigmoid(1.702 * t)}[act]
        self.layers = len({k.split(".")[2] for k in self.p
                           if k.startswith("transformer.resblocks.")})

    def _block(self, x, i, mask):
        b, n, d = x.shape
        h, pre = self.heads, f"transformer.resblocks.{i}"
        a = self._ln(x, pre + ".ln_1", EPS_TEXT)
        qkv = a @ self.p[pre + ".attn.in_proj_weight"].T + self.p[pre + ".attn.in_proj_bias"]
        q, k, v = (t.reshape(b, n, h, d // h).transpose(1, 2) for t in qkv.split(d, dim=-1))
        w = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d // h) + mask, dim=-1)
        x = x + self._linear((w @ v).transpose(1, 2).reshape(b, n, d), pre + ".attn.out_proj")
        m = self.act(self._linear(self._ln(x, pre + ".ln_2", EPS_TEXT), pre + ".mlp.c_fc"))
        return x + self._linear(m, pre + ".mlp.c_proj")

    @torch.no_grad()
    def _encode(self, tokens: torch.Tensor) -> torch.Tensor:
        tokens = tokens.long().to(self.device)
        x = self.p["token_embedding.weight"][tokens] + self.p["positional_embedding"]
        n = x.shape[1]
        mask = torch.full((n, n), float("-inf"), device=self.device).triu(1)
        for i in range(self.layers):
            x = self._block(x, i, mask)
        x = self._ln(x, "ln_final", EPS_TEXT)
        return x[torch.arange(len(x), device=self.device), tokens.argmax(dim=-1)] @ \
            self.p["text_projection"]

    def __call__(self, tokens) -> torch.Tensor:
        tokens = torch.as_tensor(tokens)
        return torch.cat([self._encode(tokens[i:i + self.block]).cpu()
                          for i in range(0, len(tokens), self.block)])
