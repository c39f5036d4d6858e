"""Proto-CLIP query adapters (counterpart of ``protoclip_tpu/models/adapters.py``).

- ``fc``      - bottleneck MLP d -> d/4 -> d with LayerNorms and the
  residual blend ``0.2 * f(x) + 0.8 * x``.
- ``conv-2x`` - pad the d-dim feature to the next square s^2, view it as a
  1-channel s x s image, 1x1 conv -> LN -> 1x1 conv -> LN, add the identity
  image, crop back to d.
- ``conv-3x`` - the same with a 3x3 conv -> LN in the middle.

The conv adapters' LayerNorms normalize over the whole (C, H, W) volume, as
``nn.LayerNorm([C, s, s])`` does; convolutions are NCHW with OIHW kernels.
The torch state-dict mapping reads and writes the reference's
``query_adapter.pt`` / ``_a.pt`` layout.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from protoclip_tpu_torch.ops.layernorm import layer_norm

Params = Dict[str, torch.Tensor]

ADAPTER_WIDTH = 16  # conv adapter channel width
FC_REDUCTION = 4  # fc bottleneck factor
FC_RATIO = 0.2  # residual blend


def adapter_square_size(c_in: int) -> int:
    return int(math.ceil(math.sqrt(c_in)))


def _apply_fc(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = layer_norm(x @ params["w1"], params["ln1"]["scale"], params["ln1"]["bias"])
    h = layer_norm(h @ params["w2"], params["ln2"]["scale"], params["ln2"]["bias"])
    return FC_RATIO * h + (1.0 - FC_RATIO) * x


def _apply_conv(params: Params, x: torch.Tensor, three_x: bool) -> torch.Tensor:
    b, d = x.shape
    s = adapter_square_size(d)
    img = F.pad(x, (0, s * s - d)).reshape(b, 1, s, s)

    def conv(t, name, padding=0):
        return F.conv2d(t, params[name].to(t.dtype), padding=padding)

    out = layer_norm(conv(img, "conv1"), params["ln1"]["scale"], params["ln1"]["bias"])
    if three_x:
        out = layer_norm(conv(out, "conv2", 1), params["ln2"]["scale"], params["ln2"]["bias"])
    out = layer_norm(conv(out, "conv3"), params["ln3"]["scale"], params["ln3"]["bias"])
    return (out + img).reshape(b, s * s)[:, :d]


def apply_adapter(params: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    """Apply the adapter of the given kind to features (B, d)."""
    if kind == "fc":
        return _apply_fc(params, x)
    if kind == "conv-2x":
        return _apply_conv(params, x, three_x=False)
    if kind == "conv-3x":
        return _apply_conv(params, x, three_x=True)
    raise ValueError(f"unknown adapter kind {kind!r}; use fc / conv-2x / conv-3x")


# -- init -------------------------------------------------------------------


def init_adapter(generator: Optional[torch.Generator], c_in: int, kind: str,
                 dtype: torch.dtype = torch.float32) -> Params:
    """Fresh adapter parameters (JAX ``adapters.py:98-132``): uniform
    weights at ``1/sqrt(fan_in)``, identity LayerNorms, drawn on the CPU
    from ``generator``."""

    def uniform(shape, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        return (torch.rand(shape, generator=generator) * (2 * bound) - bound).to(dtype)

    def ln(*shape):
        return {"scale": torch.ones(shape, dtype=dtype), "bias": torch.zeros(shape, dtype=dtype)}

    if kind == "fc":
        hidden = c_in // FC_REDUCTION
        return {"w1": uniform((c_in, hidden), c_in), "ln1": ln(hidden),
                "w2": uniform((hidden, c_in), hidden), "ln2": ln(c_in)}
    if kind in ("conv-2x", "conv-3x"):
        s, w = adapter_square_size(c_in), ADAPTER_WIDTH
        return {"conv1": uniform((w, 1, 1, 1), 1), "ln1": ln(w, s, s),
                "conv2": uniform((w, w, 3, 3), w * 9), "ln2": ln(w, s, s),
                "conv3": uniform((1, w, 1, 1), w), "ln3": ln(1, s, s)}
    raise ValueError(f"unknown adapter kind {kind!r}")


# -- torch state dicts ------------------------------------------------------

_FC_TORCH_MAP = {  # torch key: (param, leaf); "T" = the transposed weight
    "fc.0.weight": ("w1", "T"),
    "fc.1.weight": ("ln1", "scale"),
    "fc.1.bias": ("ln1", "bias"),
    "fc.2.weight": ("w2", "T"),
    "fc.3.weight": ("ln2", "scale"),
    "fc.3.bias": ("ln2", "bias"),
}
_CONV_TORCH_MAP = {
    "conv1.weight": ("conv1", None),
    "bn1.weight": ("ln1", "scale"),
    "bn1.bias": ("ln1", "bias"),
    "conv2.weight": ("conv2", None),
    "bn2.weight": ("ln2", "scale"),
    "bn2.bias": ("ln2", "bias"),
    "conv3.weight": ("conv3", None),
    "bn3.weight": ("ln3", "scale"),
    "bn3.bias": ("ln3", "bias"),
}


def _torch_map(kind: str) -> Dict:
    if kind == "fc":
        return _FC_TORCH_MAP
    if kind in ("conv-2x", "conv-3x"):
        return _CONV_TORCH_MAP
    raise ValueError(f"unknown adapter kind {kind!r}")


def adapter_from_torch_state(state: Dict, kind: str, dtype: torch.dtype = torch.float32) -> Params:
    """A torch ``state_dict`` (``query_adapter.pt``, ``_a.pt``; tensors or
    arrays) -> adapter params.  conv-2x checkpoints still carry the unused
    conv2/bn2, kept for round trips (ref ``model.py:66-68``)."""
    out: Dict = {}
    for key, (name, leaf) in _torch_map(kind).items():
        if kind != "fc" and key not in state:
            continue
        value = torch.from_numpy(np.array(state[key], np.float32))
        if leaf == "T":
            out[name] = value.T.contiguous().to(dtype)
        elif leaf is None:
            out[name] = value.to(dtype)
        else:
            out.setdefault(name, {})[leaf] = value.to(dtype)
    return out


def adapter_to_torch_state(params: Params, kind: str) -> Dict[str, np.ndarray]:
    """Adapter params -> the reference's ``state_dict`` layout, as fp32
    numpy arrays."""
    state: Dict[str, np.ndarray] = {}
    for key, (name, leaf) in _torch_map(kind).items():
        node = params.get(name)
        if node is None:
            continue
        value = node if leaf in (None, "T") else node[leaf]
        value = torch.as_tensor(value).detach().float().cpu().numpy()
        state[key] = value.T if leaf == "T" else value
    return state
