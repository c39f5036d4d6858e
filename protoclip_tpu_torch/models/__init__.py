"""CLIP towers and Proto-CLIP query adapters.

Linear weights are stored input-major (``y = x @ w + b``), transposed
relative to ``torch.nn.Linear``; transformer blocks are a list of per-layer
dicts with the fused ``wqkv``.
"""

from protoclip_tpu_torch.models.adapters import apply_adapter
from protoclip_tpu_torch.models.clip import (
    BACKBONE_CONFIGS,
    CLIPConfig,
    cast_params,
    clip_forward,
    convert_clip_state_dict,
    encode_image,
    encode_text,
    infer_config_from_state_dict,
    init_clip_params,
    load_clip,
    params_from_jax,
    quantize_for_serving,
)

__all__ = [
    "apply_adapter",
    "BACKBONE_CONFIGS",
    "CLIPConfig",
    "cast_params",
    "clip_forward",
    "convert_clip_state_dict",
    "encode_image",
    "encode_text",
    "infer_config_from_state_dict",
    "init_clip_params",
    "load_clip",
    "params_from_jax",
    "quantize_for_serving",
]
