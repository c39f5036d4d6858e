"""CLIP Vision Transformer (counterpart of ``protoclip_tpu/models/vit.py``).

The patch embedding is a reshape and one matrix product, the same math as
the strided convolution of the reference for stride == kernel == patch.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from protoclip_tpu_torch.models.layers import init_block_params, transformer
from protoclip_tpu_torch.ops.layernorm import layer_norm


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, 3) -> (B, gh*gw, patch*patch*3), pixels in (py, px, c)
    order, matching the kernel layout of ``clip.convert_clip_state_dict``."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def apply_vit(params: Dict, images: torch.Tensor, cfg,
              int8: Optional[bool] = None) -> torch.Tensor:
    """Encode preprocessed images (B, H, W, 3) -> embeddings (B, embed_dim);
    ``int8`` as in :func:`layers.transformer`."""
    dtype = params["patch_embed"].dtype
    x = patchify(images.to(dtype), cfg.vision_patch_size) @ params["patch_embed"]
    cls = params["class_embedding"].to(dtype).expand(x.shape[0], 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + params["positional_embedding"].to(dtype)
    x = layer_norm(x, params["ln_pre"]["scale"], params["ln_pre"]["bias"])
    x = transformer(x, params["blocks"], cfg.vision_heads, qblocks=params.get("blocks_q"),
                    int8=int8)
    cls_out = layer_norm(x[:, 0, :], params["ln_post"]["scale"], params["ln_post"]["bias"])
    return cls_out @ params["proj"].to(dtype)


def init_vit_params(rng: np.random.Generator, cfg, dtype: torch.dtype = torch.float32) -> Dict:
    width, patch = cfg.vision_width, cfg.vision_patch_size
    n_tokens = (cfg.image_resolution // patch) ** 2 + 1
    scale = width ** -0.5

    def randn(*shape, std):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * std).to(dtype)

    def ln():
        return {"scale": torch.ones(width, dtype=dtype), "bias": torch.zeros(width, dtype=dtype)}

    return {
        "patch_embed": randn(patch * patch * 3, width, std=scale),
        "class_embedding": randn(width, std=scale),
        "positional_embedding": randn(n_tokens, width, std=scale),
        "ln_pre": ln(),
        "blocks": init_block_params(rng, cfg.vision_layers, width, dtype),
        "ln_post": ln(),
        "proj": randn(width, cfg.embed_dim, std=scale),
    }
