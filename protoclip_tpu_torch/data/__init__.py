"""Data helpers of the port: the eval-time PIL preprocessing, the
device-side CLIP normalization and an in-memory batch loader.  The dataset
adapters, the threaded loader and the train-time transforms come with the
host data-path slice."""

from protoclip_tpu_torch.data.loader import ArrayLoader
from protoclip_tpu_torch.data.transforms import (
    CLIP_MEAN,
    CLIP_STD,
    center_crop,
    clip_preprocess,
    load_image,
    normalize_batch,
    resize_shorter,
)

__all__ = [
    "ArrayLoader",
    "CLIP_MEAN",
    "CLIP_STD",
    "center_crop",
    "clip_preprocess",
    "load_image",
    "normalize_batch",
    "resize_shorter",
]
