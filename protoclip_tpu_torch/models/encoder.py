"""Standalone embed + self-attention encoder (counterpart of
``protoclip_tpu/models/encoder.py``): the reference's unused
``Embedder``/``MultiHeadAttention``/``Encoder`` (``model.py:98-170``).

An embedding table initialised from a caller-provided weight matrix and one
multi-head self-attention layer, nothing else (no FFN, no LayerNorm, no
residual).  Nothing in the reference instantiates it; it is part of the
shipped surface, so it is here as pure functions over a dict of tensors,
linear weights input-major (``y = x @ w + b``).

Two reference quirks are kept on purpose, as the JAX package keeps them:

* softmax is applied only inside the mask branch (``model.py:110-118``):
  without a mask the raw scaled scores are the mixing weights;
* dropout acts on the (post-softmax or raw) score matrix
  (``model.py:119-121``).  Pass a ``torch.Generator`` as ``dropout_rng`` to
  enable it; without one it is the identity (torch ``Dropout`` in eval
  mode).  The keep mask is ``torch.rand(scores.shape, generator=g) <
  1 - rate``, drawn on the CPU, so a seed gives the same mask on any device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = [
    "init_encoder",
    "encoder_from_torch_state",
    "multi_head_attention",
    "encoder_apply",
]


def init_encoder(rng: np.random.Generator, embed_weights, heads: int) -> dict:
    """Fresh encoder params, drawn from the numpy ``rng`` as the JAX
    package draws them.  ``embed_weights`` (V, D) seeds the embedding table
    (``model.py:99-103``); the four projections follow ``nn.Linear``'s
    default (uniform in +-1/sqrt(fan_in), ``model.py:126-133``)."""
    table = np.asarray(embed_weights, np.float32)
    d_model = table.shape[1]
    if d_model % heads:
        raise ValueError(f"d_model {d_model} not divisible by heads {heads}")

    def uniform(shape):
        bound = 1.0 / np.sqrt(d_model)
        return torch.from_numpy(rng.uniform(-bound, bound, shape).astype(np.float32))

    def linear():
        # stored input-major: y = x @ w + b (torch keeps (out, in))
        return {"w": uniform((d_model, d_model)), "b": uniform(d_model)}

    return {
        "embed": torch.from_numpy(table.copy()),
        "q": linear(),
        "k": linear(),
        "v": linear(),
        "out": linear(),
    }


def encoder_from_torch_state(state: dict, prefix: str = "") -> dict:
    """A torch ``Encoder`` state dict (``model.py:164-170``:
    ``embed.embed.weight`` and ``attn.{q,k,v}_linear``/``attn.out``) as the
    input-major tree :func:`encoder_apply` takes."""

    def tensor(x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32))

    def linear(name):
        return {
            "w": tensor(state[f"{prefix}attn.{name}.weight"]).T.contiguous(),
            "b": tensor(state[f"{prefix}attn.{name}.bias"]),
        }

    return {
        "embed": tensor(state[f"{prefix}embed.embed.weight"]),
        "q": linear("q_linear"),
        "k": linear("k_linear"),
        "v": linear("v_linear"),
        "out": linear("out"),
    }


def multi_head_attention(params: dict, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         heads: int, mask: Optional[torch.Tensor] = None, *,
                         dropout_rate: float = 0.1,
                         dropout_rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """``MultiHeadAttention.forward`` (``model.py:123-160``).  ``mask`` is
    (B, Lq, Lk) with 0 at masked positions, broadcast over the heads;
    softmax runs only when a mask is given (see the module docstring)."""
    b = q.shape[0]
    d_k = params["q"]["w"].shape[1] // heads

    def project(p, x):
        # (B, L, D) -> (B, H, L, d_k): torch's view + transpose(1, 2)
        y = x @ p["w"] + p["b"]
        return y.reshape(b, -1, heads, d_k).transpose(1, 2)

    qh, kh, vh = project(params["q"], q), project(params["k"], k), project(params["v"], v)
    scores = qh @ kh.transpose(-2, -1) / torch.sqrt(torch.tensor(d_k, dtype=qh.dtype))
    if mask is not None:
        scores = scores.masked_fill(mask[:, None] == 0, -1e9)
        scores = torch.softmax(scores, dim=-1)
    if dropout_rng is not None:
        keep = torch.rand(scores.shape, generator=dropout_rng) < 1.0 - dropout_rate
        scores = torch.where(keep.to(scores.device), scores / (1.0 - dropout_rate),
                             torch.zeros((), dtype=scores.dtype, device=scores.device))
    mixed = scores @ vh  # (B, H, Lq, d_k)
    concat = mixed.transpose(1, 2).reshape(b, -1, heads * d_k)
    return concat @ params["out"]["w"] + params["out"]["b"]


def encoder_apply(params: dict, tokens, heads: int, mask: Optional[torch.Tensor] = None,
                  **dropout_kw) -> torch.Tensor:
    """``Encoder.forward`` (``model.py:168-170``): embed, then one
    self-attention pass with query = key = value = the embeddings."""
    table = params["embed"]
    x = table[torch.as_tensor(tokens, device=table.device).long()]
    return multi_head_attention(params, x, x, x, heads, mask, **dropout_kw)
