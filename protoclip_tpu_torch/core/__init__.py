"""The experiment config and the Proto-CLIP classifier built from memory
banks and an adapter."""

from protoclip_tpu_torch.core.config import Config, load_config
from protoclip_tpu_torch.core.protoclip import ProtoClip, accuracy, from_arrays, predict

__all__ = ["Config", "ProtoClip", "accuracy", "from_arrays", "load_config", "predict"]
