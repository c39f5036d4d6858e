"""Proto-CLIP query adapters (counterpart of ``protoclip_tpu/models/adapters.py``).

- ``fc``      - bottleneck MLP d -> d/4 -> d with LayerNorms and the
  residual blend ``0.2 * f(x) + 0.8 * x``.
- ``conv-2x`` - pad the d-dim feature to the next square s^2, view it as a
  1-channel s x s image, 1x1 conv -> LN -> 1x1 conv -> LN, add the identity
  image, crop back to d.
- ``conv-3x`` - the same with a 3x3 conv -> LN in the middle.

The conv adapters' LayerNorms normalize over the whole (C, H, W) volume, as
``nn.LayerNorm([C, s, s])`` does; convolutions are NCHW with OIHW kernels.
Initialization and the torch state-dict round trip come with the trainer
and checkpoint slices.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from protoclip_tpu_torch.ops.layernorm import layer_norm

Params = Dict[str, torch.Tensor]

ADAPTER_WIDTH = 16  # conv adapter channel width
FC_REDUCTION = 4  # fc bottleneck factor
FC_RATIO = 0.2  # residual blend


def adapter_square_size(c_in: int) -> int:
    return int(math.ceil(math.sqrt(c_in)))


def _apply_fc(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = layer_norm(x @ params["w1"], params["ln1"]["scale"], params["ln1"]["bias"])
    h = layer_norm(h @ params["w2"], params["ln2"]["scale"], params["ln2"]["bias"])
    return FC_RATIO * h + (1.0 - FC_RATIO) * x


def _apply_conv(params: Params, x: torch.Tensor, three_x: bool) -> torch.Tensor:
    b, d = x.shape
    s = adapter_square_size(d)
    img = F.pad(x, (0, s * s - d)).reshape(b, 1, s, s)

    def conv(t, name, padding=0):
        return F.conv2d(t, params[name].to(t.dtype), padding=padding)

    out = layer_norm(conv(img, "conv1"), params["ln1"]["scale"], params["ln1"]["bias"])
    if three_x:
        out = layer_norm(conv(out, "conv2", 1), params["ln2"]["scale"], params["ln2"]["bias"])
    out = layer_norm(conv(out, "conv3"), params["ln3"]["scale"], params["ln3"]["bias"])
    return (out + img).reshape(b, s * s)[:, :d]


def apply_adapter(params: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    """Apply the adapter of the given kind to features (B, d)."""
    if kind == "fc":
        return _apply_fc(params, x)
    if kind == "conv-2x":
        return _apply_conv(params, x, three_x=False)
    if kind == "conv-3x":
        return _apply_conv(params, x, three_x=True)
    raise ValueError(f"unknown adapter kind {kind!r}; use fc / conv-2x / conv-3x")
