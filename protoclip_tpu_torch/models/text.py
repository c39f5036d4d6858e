"""CLIP text transformer (counterpart of ``protoclip_tpu/models/text.py``)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from protoclip_tpu_torch.models.layers import init_block_params, transformer
from protoclip_tpu_torch.ops.layernorm import layer_norm


def apply_text(params: Dict, tokens: torch.Tensor, cfg,
               int8: Optional[bool] = None) -> torch.Tensor:
    """Encode token ids (B, context) -> embeddings (B, embed_dim); ``int8``
    as in :func:`layers.transformer`, the MLP's activation
    ``cfg.text_act``.

    The sequence feature is taken at the EOT position: the argmax token id,
    since EOT is the largest id in any sequence.

    An id past the token embedding's rows takes the last row, as JAX's
    gather clamps it (``protoclip_tpu/models/text.py:23``), so a checkpoint
    with a vocabulary smaller than CLIP's still takes the banks' EOT
    padding (49407); the EOT position is still the argmax of the ids as
    given.  No host sync: the clamp runs on the device.
    """
    dtype = params["token_embedding"].dtype
    tokens = tokens.long()
    rows = tokens.clamp(max=params["token_embedding"].shape[0] - 1)
    x = params["token_embedding"][rows] + params["positional_embedding"].to(dtype)
    x = transformer(x, params["blocks"], cfg.transformer_heads, causal=True,
                    qblocks=params.get("blocks_q"), int8=int8, act=cfg.text_act)
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
