"""Numeric ops: LayerNorm, QuickGELU, attention, prototype math, the
training losses, and the hand-written CUDA kernels of the transformer block
(``ops.kernels``)."""

from protoclip_tpu_torch.ops.activations import quick_gelu
from protoclip_tpu_torch.ops.attention import (
    attention_core,
    cross_attention_single_query,
    multi_head_attention,
)
from protoclip_tpu_torch.ops.layernorm import layer_norm
from protoclip_tpu_torch.ops.losses import info_nce, nll_of_probs, protoclip_loss
from protoclip_tpu_torch.ops.proto import (
    class_prototypes,
    l2_normalize,
    proto_logits,
    proto_predict,
    proto_probs,
    squared_euclidean,
)

__all__ = [
    "quick_gelu",
    "attention_core",
    "cross_attention_single_query",
    "multi_head_attention",
    "layer_norm",
    "info_nce",
    "nll_of_probs",
    "protoclip_loss",
    "class_prototypes",
    "l2_normalize",
    "proto_logits",
    "proto_predict",
    "proto_probs",
    "squared_euclidean",
]
