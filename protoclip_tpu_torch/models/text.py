"""CLIP text transformer (counterpart of ``protoclip_tpu/models/text.py``)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from protoclip_tpu_torch.models.layers import init_block_params, transformer
from protoclip_tpu_torch.ops.layernorm import layer_norm


def apply_text(params: Dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """Encode token ids (B, context) -> embeddings (B, embed_dim).

    The sequence feature is taken at the EOT position: the argmax token id,
    since EOT is the largest id in any sequence.
    """
    dtype = params["token_embedding"].dtype
    tokens = tokens.long()
    x = params["token_embedding"][tokens] + params["positional_embedding"].to(dtype)
    x = transformer(x, params["blocks"], cfg.transformer_heads, causal=True,
                    qblocks=params.get("blocks_q"))
    x = layer_norm(x, params["ln_final"]["scale"], params["ln_final"]["bias"])
    eot = tokens.argmax(dim=-1)
    feats = x[torch.arange(x.shape[0], device=x.device), eot]
    return feats @ params["text_projection"].to(dtype)


def init_text_params(rng: np.random.Generator, cfg, dtype: torch.dtype = torch.float32) -> Dict:
    width = cfg.transformer_width

    def randn(*shape, std):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * std).to(dtype)

    return {
        "token_embedding": randn(cfg.vocab_size, width, std=0.02),
        "positional_embedding": randn(cfg.context_length, width, std=0.01),
        "blocks": init_block_params(rng, cfg.transformer_layers, width, dtype),
        "ln_final": {"scale": torch.ones(width, dtype=dtype),
                     "bias": torch.zeros(width, dtype=dtype)},
        "text_projection": randn(width, cfg.embed_dim, std=width ** -0.5),
    }
