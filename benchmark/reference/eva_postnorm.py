"""EVA02-CLIP-bigE's post-norm image tower in plain fp32 PyTorch over its
state-dict layout.

Written from EVA-CLIP (baaivision/EVA ``EVA-CLIP/rei/eva_clip/
eva_vit_model.py``: ``EVAVisionTransformer`` with ``postnorm`` and
neither ``subln``, ``naiveswiglu`` nor ``rope``): the patch embedding with
its bias, the class token and learned positions, no ``ln_pre``; each
``Block`` computes x + norm1(attn(x)), then x + norm2(mlp(x)), where
``Attention`` is one ``qkv`` product with the bias [q_bias, 0, v_bias],
softmax((q * head_dim^-0.5) k^T) v and ``proj``, and ``Mlp`` is ``fc1``,
``nn.GELU`` (erf), ``fc2``; LayerNorm eps 1e-6; ``norm`` over the sequence,
then the class token through ``head``.  The text tower is
``reference/eva.py``'s ``TextTower``.  The products run in full fp32
(TF32 off), in blocks of images.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference.clip import MEAN, STD
from benchmark.reference.eva import EPS_VISION, _Tower


class PostnormImageTower(_Tower):
    """``__call__(uint8 (B, H, W, 3)) -> fp32 (B, embed_dim)``, computed in
    blocks of ``block`` images."""

    def __init__(self, state_dict: Dict[str, torch.Tensor], heads: int, device: str,
                 block: int = 32):
        super().__init__(state_dict, "visual.", device, block)
        self.heads = heads
        self.layers = len({k.split(".")[1] for k in self.p if k.startswith("blocks.")})
        self.mean = torch.tensor(MEAN, device=device)
        self.std = torch.tensor(STD, device=device)

    def _attention(self, x, pre):
        b, n, d = x.shape
        q_bias, v_bias = self.p[pre + ".q_bias"], self.p[pre + ".v_bias"]
        qkv = F.linear(x, self.p[pre + ".qkv.weight"],
                       torch.cat([q_bias, torch.zeros_like(v_bias), v_bias]))
        q, k, v = qkv.reshape(b, n, 3, self.heads, -1).permute(2, 0, 3, 1, 4)
        w = torch.softmax((q * (d // self.heads) ** -0.5) @ k.transpose(-1, -2), dim=-1)
        return self._linear((w @ v).transpose(1, 2).reshape(b, n, d), pre + ".proj")

    def _block(self, x, i):
        pre = f"blocks.{i}"
        x = x + self._ln(self._attention(x, pre + ".attn"), pre + ".norm1", EPS_VISION)
        m = self._linear(F.gelu(self._linear(x, pre + ".mlp.fc1")), pre + ".mlp.fc2")
        return x + self._ln(m, pre + ".norm2", EPS_VISION)

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
