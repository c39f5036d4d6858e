"""OpenAI CLIP's image tower in plain fp32 PyTorch, over its state-dict
layout (openai/CLIP ``model.py``: ``VisionTransformer``,
``ResidualAttentionBlock``, ``QuickGELU``), and ``ToTensor + Normalize``.

The products run in full fp32: TF32 is turned off for matrix products and
cuDNN convolutions before any runs.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)
LN_EPS = 1e-5


class ImageTower:
    """``__call__(uint8 (B, H, W, 3)) -> fp32 (B, embed_dim)``, computed in
    blocks of ``block`` images."""

    def __init__(self, state_dict: Dict[str, torch.Tensor], heads: int, device: str,
                 block: int = 64):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.p = {k[len("visual."):]: v.to(device=device, dtype=torch.float32)
                  for k, v in state_dict.items() if k.startswith("visual.")}
        self.layers = sum(1 for k in self.p if k.endswith(".attn.in_proj_weight"))
        self.heads = heads
        self.device = device
        self.block = block
        self.patch = self.p["conv1.weight"].shape[-1]
        self.mean = torch.tensor(MEAN, device=device)
        self.std = torch.tensor(STD, device=device)

    def _ln(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.p[f"{name}.weight"], self.p[f"{name}.bias"],
                            LN_EPS)

    def _linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return x @ self.p[f"{name}.weight"].T + self.p[f"{name}.bias"]

    def _attention(self, x: torch.Tensor, pre: str) -> torch.Tensor:
        b, length, width = x.shape
        dh = width // self.heads
        qkv = x @ self.p[f"{pre}.in_proj_weight"].T + self.p[f"{pre}.in_proj_bias"]
        q, k, v = (t.reshape(b, length, self.heads, dh).transpose(1, 2)
                   for t in qkv.split(width, dim=-1))
        weights = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh), dim=-1)
        out = (weights @ v).transpose(1, 2).reshape(b, length, width)
        return self._linear(out, f"{pre}.out_proj")

    def _block(self, x: torch.Tensor, i: int) -> torch.Tensor:
        pre = f"transformer.resblocks.{i}"
        x = x + self._attention(self._ln(x, f"{pre}.ln_1"), f"{pre}.attn")
        h = self._linear(self._ln(x, f"{pre}.ln_2"), f"{pre}.mlp.c_fc")
        h = h * torch.sigmoid(1.702 * h)
        return x + self._linear(h, f"{pre}.mlp.c_proj")

    @torch.no_grad()
    def _encode(self, images_u8: torch.Tensor) -> torch.Tensor:
        x = (images_u8.to(self.device).float() / 255.0 - self.mean) / self.std
        x = F.conv2d(x.permute(0, 3, 1, 2), self.p["conv1.weight"], stride=self.patch)
        x = x.flatten(2).transpose(1, 2)
        cls = self.p["class_embedding"].expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.p["positional_embedding"]
        x = self._ln(x, "ln_pre")
        for i in range(self.layers):
            x = self._block(x, i)
        return self._ln(x[:, 0], "ln_post") @ self.p["proj"]

    def __call__(self, images_u8) -> torch.Tensor:
        images_u8 = torch.as_tensor(images_u8)
        return torch.cat([self._encode(images_u8[i:i + self.block]).cpu()
                          for i in range(0, len(images_u8), self.block)])
