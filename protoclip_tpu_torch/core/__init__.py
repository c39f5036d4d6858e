"""The Proto-CLIP classifier built from memory banks and an adapter."""

from protoclip_tpu_torch.core.protoclip import ProtoClip, accuracy, from_arrays, predict

__all__ = ["ProtoClip", "accuracy", "from_arrays", "predict"]
