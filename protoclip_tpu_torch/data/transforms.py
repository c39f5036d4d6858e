"""CLIP image preprocessing (counterpart of ``protoclip_tpu/data/
transforms.py``): PIL decode, resize and crop to uint8 on the host, and the
normalization on the tensor's device.

Eval: Resize(bicubic) -> CenterCrop (``clip/clip.py:77-84``).  Train:
RandomResizedCrop(scale 0.5-1, bicubic) + HorizontalFlip(0.5)
(``datasets/imagenet.py:8-23``), drawn from a Python ``random.Random``
exactly as the JAX package draws them, so a seeded loader picks the same
crops and flips in both packages.

PIL is imported inside the functions that use it.  The eval transform runs
the native fused resize + crop (``protoclip_tpu_torch.native``, pixel-exact
with the PIL path) where it builds.
"""

from __future__ import annotations

import math
import random as _random
from typing import Dict, Optional, Tuple

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
    """Eval-time transform of a PIL image -> uint8 (n_px, n_px, 3).

    Uses the native fused resize + crop (``protoclip_tpu_torch.native``)
    where the C++ helper builds: pixel-exact with the PIL path (held by
    ``tests/test_torch_native.py`` across geometries), and faster because
    it computes only the pixels the crop keeps.  Falls back to PIL;
    ``$PROTOCLIP_NATIVE=0`` forces the PIL path, ``1`` makes a missing
    native library an error."""
    if img.mode != "RGB":
        img = img.convert("RGB")
    from protoclip_tpu_torch import native  # the first call may compile the .so

    # probe before np.asarray: the full-frame copy only serves the native path
    if native.load() is not None:
        out = native.resize_shorter_center_crop(np.asarray(img, np.uint8), n_px, n_px)
        if out is not None:  # the native path may decline the geometry
            return out
    return np.asarray(center_crop(resize_shorter(img, n_px), n_px), dtype=np.uint8)


def sample_rrc_box(w: int, h: int, rng: _random.Random,
                   scale: Tuple[float, float] = (0.5, 1.0),
                   ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)
                   ) -> Tuple[int, int, int, int]:
    """torchvision RandomResizedCrop box sampling (10 attempts, then a
    clamped centre crop) -> (left, top, right, bottom)."""
    area = w * h
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = rng.randint(0, w - cw)
            top = rng.randint(0, h - ch)
            return left, top, left + cw, top + ch
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    left, top = (w - cw) // 2, (h - ch) // 2
    return left, top, left + cw, top + ch


def random_resized_crop(img, size: int, rng: _random.Random,
                        scale: Tuple[float, float] = (0.5, 1.0),
                        ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)):
    """torchvision-style RandomResizedCrop of a PIL image."""
    from PIL import Image

    box = sample_rrc_box(*img.size, rng, scale, ratio)
    return img.resize((size, size), Image.BICUBIC, box=box)


def random_train_transform(img, rng: _random.Random, n_px: int = 224) -> np.ndarray:
    """Train-time transform: RandomResizedCrop(scale 0.5-1) + HFlip(0.5)
    -> uint8 (n_px, n_px, 3)."""
    from PIL import Image

    box = sample_rrc_box(*img.size, rng)
    flip = rng.random() < 0.5
    img = img.resize((n_px, n_px), Image.BICUBIC, box=box)
    if flip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return np.asarray(img, dtype=np.uint8)


class EvalTransform:
    """Eval transform: ``(PIL image, rng) -> uint8 (n_px, n_px, 3)``."""

    def __init__(self, n_px: int = 224):
        self.n_px = n_px

    def __call__(self, img, rng: Optional[_random.Random] = None) -> np.ndarray:
        return clip_preprocess(img, self.n_px)


class TrainTransform:
    """Train transform, random from the loader's per-image ``rng``."""

    def __init__(self, n_px: int = 224):
        self.n_px = n_px

    def __call__(self, img, rng: Optional[_random.Random] = None) -> np.ndarray:
        return random_train_transform(img, rng or _random, self.n_px)


# (mean * 255, 1 / (std * 255)) in fp32, one pair per device: uploaded
# once, so a call makes no host-to-device copy (which would wait for the
# stream, and which a CUDA graph cannot capture)
_NORMALIZE_CONSTANTS: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _normalize_constants(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    consts = _NORMALIZE_CONSTANTS.get(device)
    if consts is None:
        mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=device) * 255.0
        inv_std = 1.0 / (torch.tensor(CLIP_STD, dtype=torch.float32, device=device) * 255.0)
        consts = _NORMALIZE_CONSTANTS.setdefault(device, (mean, inv_std))
    return consts


def normalize_batch(images_u8: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``ToTensor + Normalize`` on the tensor's device: uint8 (B, H, W, 3)
    -> normalized, channels last, in ``dtype``."""
    mean, inv_std = _normalize_constants(images_u8.device)
    return ((images_u8.float() - mean) * inv_std).to(dtype)
