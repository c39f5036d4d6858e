"""Data helpers of this slice: the device-side CLIP normalization and an
in-memory batch loader.  The PIL pipeline and the dataset adapters come
with the host data-path slice."""

from protoclip_tpu_torch.data.loader import ArrayLoader
from protoclip_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD, normalize_batch

__all__ = ["ArrayLoader", "CLIP_MEAN", "CLIP_STD", "normalize_batch"]
