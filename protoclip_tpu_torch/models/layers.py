"""Shared transformer building blocks (counterpart of
``protoclip_tpu/models/layers.py``).

CLIP's residual attention block: pre-LN multi-head attention and a pre-LN
MLP with QuickGELU (or, in the EVA02-CLIP text towers, the exact GELU).
Blocks are a list of per-layer dicts (the JAX package stacks them along a
leading axis for ``lax.scan``); each layer's attention holds the fused
``wqkv`` (D, 3D) and ``bqkv`` (3D,) built once at load.  The EVA02 image
tower's blocks (``models/eva.py``) run :func:`eva_transformer`, the
post-norm blocks of EVA02-CLIP-bigE :func:`eva_postnorm_transformer`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from protoclip_tpu_torch.ops.activations import quick_gelu
from protoclip_tpu_torch.ops.attention import _causal_mask, multi_head_attention
from protoclip_tpu_torch.ops.kernels import (
    fused_eva_block,
    fused_eva_postnorm_block,
    fused_transformer_block,
    fused_transformer_block_int8,
    int8_enabled,
    quantize_block,
)
from protoclip_tpu_torch.ops.layernorm import layer_norm

Params = Dict[str, torch.Tensor]


_ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": torch.nn.functional.gelu}


def mlp(x: torch.Tensor, p: Params, act: str = "quick_gelu") -> torch.Tensor:
    """4x-expansion MLP with QuickGELU (``act``: or the exact ``gelu``), in
    the activation dtype."""
    dtype = x.dtype
    h = _ACTIVATIONS[act](x @ p["w_fc"].to(dtype) + p["b_fc"].to(dtype))
    return h @ p["w_proj"].to(dtype) + p["b_proj"].to(dtype)


def residual_block(x: torch.Tensor, p: Dict, n_head: int,
                   mask: Optional[torch.Tensor] = None, causal: bool = False,
                   act: str = "quick_gelu") -> torch.Tensor:
    x = x + multi_head_attention(
        layer_norm(x, p["ln_1"]["scale"], p["ln_1"]["bias"]), p["attn"], n_head, mask,
        causal=causal,
    )
    return x + mlp(layer_norm(x, p["ln_2"]["scale"], p["ln_2"]["bias"]), p["mlp"], act)


def transformer(x: torch.Tensor, blocks: List[Dict], n_head: int,
                mask: Optional[torch.Tensor] = None, causal: bool = False,
                qblocks: Optional[List[Dict]] = None,
                int8: Optional[bool] = None, act: str = "quick_gelu") -> torch.Tensor:
    """Run the residual blocks in order.

    Without an explicit mask every layer is one call of K2
    (``ops.kernels.fused_transformer_block``): the CUDA kernel chain for
    tensors on the card, its plain version on the CPU.  The kernels mask by
    length, so L is not padded.  An explicit additive mask takes
    :func:`residual_block`.

    With ``$PROTOCLIP_INT8`` on (and no mask) every layer is one call of
    K3, the W8A8 block (``ops.kernels.fused_transformer_block_int8``), on
    ``qblocks``: the int8 layers that ``models.clip.quantize_for_serving``
    made at load.  Without them the blocks are quantized here, once per
    call.  ``int8`` picks the mode explicitly (a serving bundle carries its
    own); None reads ``$PROTOCLIP_INT8``.

    ``act``: the MLP's activation (``quick_gelu``, or ``gelu`` for the
    EVA02-CLIP text towers, which K3 does not run: it raises there).
    """
    if int8 is None:
        int8 = int8_enabled()
    if mask is None and int8:
        if act != "quick_gelu":
            raise ValueError(f"the W8A8 serving block (K3, $PROTOCLIP_INT8) has no {act!r} MLP")
        if qblocks is None:
            qblocks = [quantize_block(block) for block in blocks]
        for qblock in qblocks:
            x = fused_transformer_block_int8(x, qblock, n_head, causal=causal)
        return x
    for block in blocks:
        if mask is None:
            x = fused_transformer_block(x, block, n_head, causal=causal, act=act)
        else:
            x = residual_block(x, block, n_head, mask, causal=causal, act=act)
    return x


def eva_transformer(x: torch.Tensor, blocks: List[Dict], n_head: int,
                    rope: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Run EVA02 image blocks in order, each one call of
    ``ops.kernels.fused_eva_block`` (its kernel chain on the card, its
    plain version on the CPU), with the tower's RoPE tables ``rope``
    (``cos``, ``sin``: (L - 1, head_dim) fp32)."""
    for block in blocks:
        x = fused_eva_block(x, block, n_head, rope["cos"], rope["sin"])
    return x


def eva_postnorm_transformer(x: torch.Tensor, blocks: List[Dict], n_head: int) -> torch.Tensor:
    """Run post-norm image blocks in order (x + LN1(Attn(x)), x +
    LN2(MLP(x))), each one call of ``ops.kernels.fused_eva_postnorm_block``
    (its kernel chain on the card, its plain version on the CPU); the
    residual stream is never normalised inside the tower."""
    for block in blocks:
        x = fused_eva_postnorm_block(x, block, n_head)
    return x


def init_block_params(rng: np.random.Generator, n_layers: int, width: int,
                      dtype: torch.dtype = torch.float32) -> List[Dict]:
    """Random-init transformer blocks with CLIP's init scheme, from a numpy
    generator; the QKV weights come out fused as ``wqkv``/``bqkv``."""
    proj_std = (width ** -0.5) * ((2 * n_layers) ** -0.5)
    attn_std = width ** -0.5
    fc_std = (2 * width) ** -0.5

    def norm(shape, std):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * std).to(dtype)

    def zeros(n):
        return torch.zeros(n, dtype=dtype)

    def ln():
        return {"scale": torch.ones(width, dtype=dtype), "bias": zeros(width)}

    return [
        {
            "ln_1": ln(),
            "attn": {"wqkv": norm((width, 3 * width), attn_std), "bqkv": zeros(3 * width),
                     "wo": norm((width, width), proj_std), "bo": zeros(width)},
            "ln_2": ln(),
            "mlp": {"w_fc": norm((width, 4 * width), fc_std), "b_fc": zeros(4 * width),
                    "w_proj": norm((4 * width, width), proj_std), "b_proj": zeros(width)},
        }
        for _ in range(n_layers)
    ]


def causal_mask(length: int, device=None) -> torch.Tensor:
    """Additive causal mask (ref ``clip/model.py:326-332``): (L, L) fp32,
    ``-inf`` above the diagonal."""
    return _causal_mask(length, device)
