"""Multi-head attention for CLIP's text and vision towers (counterpart of
``protoclip_tpu/ops/attention.py``).

Parameter convention: projections are stored input-major, ``y = x @ w + b``.
Self-attention takes the fused ``wqkv`` (D, 3D) and ``bqkv`` (3D,) that
``models.clip`` builds once at load time, plus ``wo`` (D, D) and ``bo``;
the single-query cross attention of the ResNet pool keeps separate ``wq``,
``wk``, ``wv``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from protoclip_tpu_torch.ops.kernels import fused_attention_packed

Params = Dict[str, torch.Tensor]


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled dot-product attention over ``(..., heads, L, d_head)``.

    ``mask`` is additive (``-inf`` blocks), broadcastable to ``(..., L, L)``.
    The scores and the softmax run in fp32 whatever the input dtype.
    """
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    if mask is not None:
        scores = scores + mask.float()
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(weights, v)


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.reshape(b, l, n_head, d // n_head).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)


def _causal_mask(length: int, device=None) -> torch.Tensor:
    """Additive causal mask: ``-inf`` above the diagonal, fp32."""
    return torch.full((length, length), float("-inf"), device=device).triu(1)


def multi_head_attention(x: torch.Tensor, params: Params, n_head: int,
                         mask: Optional[torch.Tensor] = None,
                         causal: bool = False) -> torch.Tensor:
    """Self-attention over ``x`` (B, L, D).

    Without an explicit mask the attention runs through K1
    (``ops.kernels.fused_attention_packed``): the CUDA kernel for tensors
    on the card, its plain version on the CPU.  An explicit additive mask
    takes the einsum path, combined with the causal mask when asked.
    """
    dtype = x.dtype
    d = x.shape[-1]
    qkv = x @ params["wqkv"].to(dtype) + params["bqkv"].to(dtype)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    if mask is None:
        out = fused_attention_packed(q, k, v, n_head, causal=causal)
    else:
        if causal:
            mask = mask + _causal_mask(x.shape[1], x.device)
        out = _merge_heads(attention_core(
            _split_heads(q, n_head), _split_heads(k, n_head), _split_heads(v, n_head), mask
        ))
    return out @ params["wo"].to(dtype) + params["bo"].to(dtype)


def cross_attention_single_query(q_tok: torch.Tensor, kv: torch.Tensor, params: Params,
                                 n_head: int) -> torch.Tensor:
    """Attention where only one query position is needed (the ResNet
    ``AttentionPool2d`` head): ``q_tok`` (B, D) against ``kv`` (B, L, D).
    Returns (B, D_out); ``wo`` may project to another width."""
    dtype = kv.dtype
    b, l, d = kv.shape
    q = q_tok @ params["wq"].to(dtype) + params["bq"].to(dtype)
    k = kv @ params["wk"].to(dtype) + params["bk"].to(dtype)
    v = kv @ params["wv"].to(dtype) + params["bv"].to(dtype)
    dh = d // n_head
    q = q.reshape(b, n_head, 1, dh)
    k = k.reshape(b, l, n_head, dh).transpose(1, 2)
    v = v.reshape(b, l, n_head, dh).transpose(1, 2)
    out = attention_core(q, k, v).reshape(b, d)
    return out @ params["wo"].to(dtype) + params["bo"].to(dtype)
