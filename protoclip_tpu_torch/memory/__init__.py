"""Memory banks: cached CLIP features for support sets, prompts and eval
splits."""

from protoclip_tpu_torch.memory.banks import (
    build_textual_memory_bank,
    build_visual_memory_bank,
    encode_loader,
    pre_load_features,
)

__all__ = [
    "build_textual_memory_bank",
    "build_visual_memory_bank",
    "encode_loader",
    "pre_load_features",
]
