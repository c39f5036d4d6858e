"""LayerNorm with fp32 statistics under low-precision activations
(counterpart of ``protoclip_tpu/ops/layernorm.py``).

CLIP computes LayerNorm in fp32 even when the model runs in half precision:
normalize and affine-transform in fp32, cast back to the input dtype.
"""

from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Normalize over the trailing ``scale.ndim`` axes in fp32.

    ``scale``/``bias`` may be multi-dimensional (the conv adapters normalize
    over ``(C, H, W)``); the normalization axes are the last ``scale.ndim``
    axes of ``x``.
    """
    dims = tuple(range(x.ndim - scale.ndim, x.ndim))
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    centered = xf - mean
    var = centered.square().mean(dim=dims, keepdim=True)
    normed = centered * torch.rsqrt(var + eps)
    return (normed * scale.float() + bias.float()).to(x.dtype)
