"""Seeded inputs: image splits, camera frames and their JPEGs, object
crops, and a FewSOL-shaped checkpoint triple with its split file.

The triple and split copy
``chip_smoke.py::write_fewsol_checkpoint``'s shapes (unit rows, an ``fc``
adapter, ``object_<c>`` class names).  Everything is a function of the
seed alone.
"""

from __future__ import annotations

import io
import json
import math
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

FRAME_HW = (480, 640)


def child_seed(seed: int, stream: int) -> int:
    """An independent 32-bit seed for one use (weights, images, traffic)
    of the run's seed."""
    return int(np.random.SeedSequence([int(seed), stream]).generate_state(1)[0])


def smooth_images(seed: int, n: int, hw: Tuple[int, int], grid: Tuple[int, int], noise: float,
                  device: str) -> np.ndarray:
    """``n`` uint8 images (n, h, w, 3): a random colour grid blended
    bilinearly over the image, plus uniform noise of +-``noise``, drawn on
    ``device``.  Random CLIP weights map images that differ only in
    pixel noise to nearly the same features; colour layouts that differ
    keep different images' answers apart."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=device).manual_seed(int(seed))
    x = torch.rand((n, 3, *grid), generator=gen, device=device) * 255.0
    x = F.interpolate(x, size=hw, mode="bilinear", align_corners=False)
    x += (torch.rand((n, 3, *hw), generator=gen, device=device) * 2.0 - 1.0) * noise
    return x.clamp_(0, 255).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()


def split_images(seed: int, n: int, px: int, device: str) -> np.ndarray:
    """A support split of ``n`` images of ``px`` a side."""
    return smooth_images(seed, n, (px, px), (4, 4), 16.0, device)


def frames(seed: int, count: int, objects: int = 10) -> List[np.ndarray]:
    """``count`` 480 x 640 camera frames of a table: a smooth background
    with noise and ``objects`` boxes of 40-160 px, each a colour with
    noise (drawn on the host, so a frame is the same whatever the card)."""
    rng = np.random.default_rng(seed)
    out = []
    for pixels in smooth_images(seed, count, FRAME_HW, (6, 8), 24.0, "cpu"):
        pixels = pixels.astype(np.int64)
        for _ in range(objects):
            h, w = (int(v) for v in rng.integers(40, 161, 2))
            top, left = rng.integers(0, FRAME_HW[0] - h), rng.integers(0, FRAME_HW[1] - w)
            pixels[top:top + h, left:left + w] = rng.integers(0, 256, 3) + rng.integers(
                -24, 25, (h, w, 3))
        out.append(np.clip(pixels, 0, 255).astype(np.uint8))
    return out


def jpeg(pixels: np.ndarray, quality: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def crops(rng: np.random.Generator, frames_: List[np.ndarray], n: int,
          side: Tuple[int, int]) -> List[np.ndarray]:
    """``n`` crops, each side uniform over ``side`` (inclusive), cut at a
    uniform place of a uniform frame."""
    out = []
    for _ in range(n):
        frame = frames_[int(rng.integers(len(frames_)))]
        ch, cw = (int(v) for v in rng.integers(side[0], side[1] + 1, 2))
        top = int(rng.integers(0, frame.shape[0] - ch + 1))
        left = int(rng.integers(0, frame.shape[1] - cw + 1))
        out.append(np.ascontiguousarray(frame[top:top + ch, left:left + cw]))
    return out


def _unit_rows(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    x = rng.standard_normal((n, d))
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def fc_adapter_state(rng: np.random.Generator, d: int) -> Dict[str, np.ndarray]:
    """An ``fc`` adapter in the reference's layout: bias-free products
    uniform in +-1/sqrt(fan_in), LayerNorms as ``weights.py`` draws them."""
    hidden = d // 4
    return {
        "fc.0.weight": rng.uniform(-1, 1, (hidden, d)) / math.sqrt(d),
        "fc.1.weight": 1.0 + 0.1 * rng.standard_normal(hidden),
        "fc.1.bias": 0.02 * rng.standard_normal(hidden),
        "fc.2.weight": rng.uniform(-1, 1, (d, hidden)) / math.sqrt(hidden),
        "fc.3.weight": 1.0 + 0.1 * rng.standard_normal(d),
        "fc.3.bias": 0.02 * rng.standard_normal(d),
    }


def write_triple(rng: np.random.Generator, root: Path, n_class: int, shots: int,
                 d: int) -> Dict[str, object]:
    """The ``_v/_t/_a`` triple (fp16, as trained checkpoints store it) and
    a split file naming class ``c`` ``object_<c>``.  Returns the paths and
    the fp16 tensors that both sides read."""
    import torch

    def half(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(torch.float16)

    tensors = {"bank_v": half(_unit_rows(rng, n_class * shots, d)),
               "bank_t": half(_unit_rows(rng, n_class, d)),
               "adapter": {k: half(v) for k, v in fc_adapter_state(rng, d).items()}}
    paths = {name: str(root / f"{name}.pt") for name in tensors}
    for name, value in tensors.items():
        torch.save(value, paths[name])
    rows = [[f"object_{c:03d}/{k}.png", c, f"object_{c:03d}"]
            for c in range(n_class) for k in range(shots)]
    paths["split"] = str(root / "split.json")
    with open(paths["split"], "w") as fh:
        json.dump({"train": rows, "val": [], "test": []}, fh)
    return {"paths": paths, **tensors}


def class_of_name(n_class: int) -> Dict[str, int]:
    """The classifier's display names (underscores as spaces) -> ids."""
    return {f"object {c:03d}": c for c in range(n_class)}
