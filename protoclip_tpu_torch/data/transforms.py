"""CLIP image normalization (counterpart of the device half of
``protoclip_tpu/data/transforms.py``)."""

from __future__ import annotations

import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize_batch(images_u8: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``ToTensor + Normalize`` on the tensor's device: uint8 (B, H, W, 3)
    -> normalized, channels last, in ``dtype``."""
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=images_u8.device) * 255.0
    inv_std = 1.0 / (torch.tensor(CLIP_STD, dtype=torch.float32, device=images_u8.device) * 255.0)
    return ((images_u8.float() - mean) * inv_std).to(dtype)
