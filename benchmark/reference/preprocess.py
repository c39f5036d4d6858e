"""CLIP's eval preprocess with PIL, as openai/CLIP ``clip.py::_transform``
builds it from torchvision: ``Resize(n_px, bicubic)`` (the shorter side
to ``n_px``, the longer ``int(n_px * long / short)``), ``CenterCrop(n_px)``
(offsets ``int(round((side - n_px) / 2))``), RGB; and JPEG decode."""

from __future__ import annotations

import io

import numpy as np
from PIL import Image


def decode(raw: bytes) -> Image.Image:
    return Image.open(io.BytesIO(raw)).convert("RGB")


def clip_preprocess(img: Image.Image, n_px: int) -> np.ndarray:
    """PIL image -> uint8 (n_px, n_px, 3)."""
    img = img.convert("RGB")
    w, h = img.size
    if w <= h:
        size = (n_px, int(n_px * h / w))
    else:
        size = (int(n_px * w / h), n_px)
    img = img.resize(size, Image.BICUBIC)
    w, h = img.size
    left, top = int(round((w - n_px) / 2.0)), int(round((h - n_px) / 2.0))
    return np.asarray(img.crop((left, top, left + n_px, top + n_px)), dtype=np.uint8)
