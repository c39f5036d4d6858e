"""Memory banks: cached CLIP features for support sets, prompts and eval
splits."""

from protoclip_tpu_torch.memory.banks import (
    build_textual_memory_bank,
    build_visual_memory_bank,
    encode_loader,
    pre_load_features,
)
from protoclip_tpu_torch.memory.cache import FeatureCache

__all__ = [
    "FeatureCache",
    "build_textual_memory_bank",
    "build_visual_memory_bank",
    "encode_loader",
    "pre_load_features",
]
