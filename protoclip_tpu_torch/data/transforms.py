"""CLIP image preprocessing (counterpart of ``protoclip_tpu/data/
transforms.py``): the eval-time PIL decode, resize and crop to uint8 on
the host, and the normalization on the tensor's device.

PIL is imported inside the functions that use it.  The native C++
resize+crop helper and the train-time transforms come with the host
data-path slice (ROADMAP.md, port queue 1).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def load_image(path: str, draft_px: Optional[int] = None):
    """Open an image as RGB, retrying once on an I/O error.

    ``draft_px`` opts into libjpeg's DCT-domain scaled decode (PIL
    ``draft``), never below ``draft_px`` on the shorter side: about twice
    as fast and not pixel-exact with the torchvision pipeline, so it is off
    by default and meant for serving only.  Non-JPEG formats ignore it."""
    from PIL import Image

    def _open():
        img = Image.open(path)
        if draft_px is not None:
            img.draft("RGB", (draft_px, draft_px))
        return img.convert("RGB")

    try:
        return _open()
    except OSError:
        return _open()


def resize_shorter(img, size: int):
    """Bicubic resize so the shorter side is ``size``; pixel-exact with
    torchvision ``Resize(size)``: the long side is ``int(size * long /
    short)``, truncated."""
    from PIL import Image

    w, h = img.size
    if w <= h:
        new_w, new_h = size, max(1, int(size * h / w))
    else:
        new_w, new_h = max(1, int(size * w / h)), size
    return img.resize((new_w, new_h), Image.BICUBIC)


def center_crop(img, size: int):
    """Pixel-exact with torchvision ``CenterCrop``: offsets are
    ``int(round((dim - size) / 2))``."""
    w, h = img.size
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    return img.crop((left, top, left + size, top + size))


def clip_preprocess(img, n_px: int = 224) -> np.ndarray:
    """Eval-time transform of a PIL image -> uint8 (n_px, n_px, 3)."""
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(center_crop(resize_shorter(img, n_px), n_px), dtype=np.uint8)


def normalize_batch(images_u8: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``ToTensor + Normalize`` on the tensor's device: uint8 (B, H, W, 3)
    -> normalized, channels last, in ``dtype``."""
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=images_u8.device) * 255.0
    inv_std = 1.0 / (torch.tensor(CLIP_STD, dtype=torch.float32, device=images_u8.device) * 255.0)
    return ((images_u8.float() - mean) * inv_std).to(dtype)
