"""CLIP towers and Proto-CLIP query adapters.

Linear weights are stored input-major (``y = x @ w + b``), transposed
relative to ``torch.nn.Linear``; transformer blocks are a list of per-layer
dicts with the fused ``wqkv``.  ``multi_head_attention`` here is the
reference encoder's (``models/encoder.py``), as in the JAX package, not the
towers' (``ops/attention.py``).
"""

from protoclip_tpu_torch.models.adapters import (
    adapter_from_torch_state,
    adapter_to_torch_state,
    apply_adapter,
    init_adapter,
)
from protoclip_tpu_torch.models.clip import (
    BACKBONE_CONFIGS,
    PORT_BACKBONE_CONFIGS,
    CLIPConfig,
    available_backbones,
    backbone_config,
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
from protoclip_tpu_torch.models.encoder import (
    encoder_apply,
    encoder_from_torch_state,
    init_encoder,
    multi_head_attention,
)

__all__ = [
    "adapter_from_torch_state",
    "adapter_to_torch_state",
    "apply_adapter",
    "init_adapter",
    "BACKBONE_CONFIGS",
    "PORT_BACKBONE_CONFIGS",
    "CLIPConfig",
    "available_backbones",
    "backbone_config",
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
    "encoder_apply",
    "encoder_from_torch_state",
    "init_encoder",
    "multi_head_attention",
]
