"""The canonical serving encode (counterpart of
``protoclip_tpu/io/export.py::make_encode_fn``).

The JAX module also exports the encoder as a compiled bundle; in the port
that comes with the serving slice (ROADMAP.md, port queue 1).
"""

from __future__ import annotations

from typing import Callable

import torch

from protoclip_tpu_torch.data.transforms import normalize_batch
from protoclip_tpu_torch.models.clip import encode_image


def make_encode_fn(cfg, normalize: bool = True) -> Callable:
    """``(params, images_u8) -> (B, d) fp32``: ToTensor + Normalize on the
    images' device to bf16, the image tower (K3 when the params carry
    ``blocks_q`` and ``$PROTOCLIP_INT8`` is on, K2 otherwise), fp32
    output, and an optional L2 normalization (``export.py:116-135``).  The
    one definition the extract CLI and serving share."""

    @torch.inference_mode()
    def encode(params, images_u8: torch.Tensor) -> torch.Tensor:
        feats = encode_image(params, normalize_batch(images_u8, torch.bfloat16), cfg).float()
        if normalize:
            feats = feats / torch.linalg.norm(feats, dim=-1, keepdim=True)
        return feats

    return encode
