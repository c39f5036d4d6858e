"""CLIP ModifiedResNet (counterpart of ``protoclip_tpu/models/resnet.py``;
ref ``clip/model.py:10-152``).

The same structure: a 3-conv anti-aliased stem, Bottleneck blocks whose
strided downsampling is an average pool before a stride-1 conv, and an
attention-pool head whose only query is the spatial mean token.

Layout: images arrive NHWC (B, H, W, 3); the tower permutes them into an
NCHW *view* with channels_last strides, so no copy is made, and every
``F.conv2d`` (cuDNN on the card), elementwise op and ``F.avg_pool2d``
keeps that memory format.  Conv kernels are OIHW, stored channels_last.
Frozen BatchNorm is folded into a per-channel ``scale``/``bias`` at load.
Each of the four layers is a list of Bottleneck dicts; the first carries
the layer's stride and, where the shape changes, its ``downsample``.

The cast points are the JAX tower's: a conv casts its kernel to the
activation dtype; the folded BN and its ReLU run in fp32 and cast back;
the average pool sums in fp32 and divides before the cast; the residual
add is in the activation dtype; the pool's mean token is taken in fp32.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from protoclip_tpu_torch.ops.attention import cross_attention_single_query

Params = Dict

LAYER_STRIDES = (1, 2, 2, 2)


def conv(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    return F.conv2d(x, kernel.to(x.dtype), stride=stride, padding=padding)


def scale_bias(x: torch.Tensor, bn: Dict[str, torch.Tensor], relu: bool = False) -> torch.Tensor:
    """Folded BatchNorm: a per-channel affine in fp32 (+ optional ReLU)."""
    shape = (1, -1, 1, 1)
    out = x.float() * bn["scale"].float().view(shape) + bn["bias"].float().view(shape)
    if relu:
        out = out.clamp_min(0.0)
    return out.to(x.dtype)


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    return F.avg_pool2d(x.float(), k).to(x.dtype)


def bottleneck(x: torch.Tensor, p: Params, stride: int) -> torch.Tensor:
    """Anti-aliased Bottleneck (ref ``clip/model.py:10-53``)."""
    out = scale_bias(conv(x, p["conv1"]), p["bn1"], relu=True)
    out = scale_bias(conv(out, p["conv2"], padding=1), p["bn2"], relu=True)
    if stride > 1:
        out = avg_pool(out, stride)
    out = scale_bias(conv(out, p["conv3"]), p["bn3"])
    identity = x
    if "downsample" in p:
        if stride > 1:
            identity = avg_pool(identity, stride)
        identity = scale_bias(conv(identity, p["downsample"]["conv"]), p["downsample"]["bn"])
    return (out + identity).clamp_min(0.0)


def attention_pool(p: Params, x: torch.Tensor, n_head: int) -> torch.Tensor:
    """AttentionPool2d (ref ``clip/model.py:56-92``) with a single query row."""
    b, c, h, w = x.shape
    tokens = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
    mean_tok = tokens.float().mean(dim=1).to(x.dtype)
    tokens = torch.cat([mean_tok[:, None, :], tokens], dim=1)
    tokens = tokens + p["positional_embedding"].to(x.dtype)
    return cross_attention_single_query(tokens[:, 0, :], tokens, p, n_head)


def apply_resnet(params: Params, images: torch.Tensor, cfg) -> torch.Tensor:
    """Encode images (B, H, W, 3) -> embeddings (B, embed_dim)."""
    dtype = params["stem"]["conv1"].dtype
    x = images.to(dtype).permute(0, 3, 1, 2)  # NCHW view, channels_last strides

    stem = params["stem"]
    x = scale_bias(conv(x, stem["conv1"], stride=2, padding=1), stem["bn1"], relu=True)
    x = scale_bias(conv(x, stem["conv2"], padding=1), stem["bn2"], relu=True)
    x = scale_bias(conv(x, stem["conv3"], padding=1), stem["bn3"], relu=True)
    x = avg_pool(x, 2)

    for i, stride in enumerate(LAYER_STRIDES):
        for j, block in enumerate(params[f"layer{i + 1}"]):
            x = bottleneck(x, block, stride if j == 0 else 1)

    return attention_pool(params["attnpool"], x, cfg.vision_heads_resnet)


# -- initialization ---------------------------------------------------------


def oihw(kernel) -> torch.Tensor:
    """An OIHW conv kernel as an fp32 tensor with channels_last strides."""
    return torch.from_numpy(np.array(kernel, np.float32)).contiguous(
        memory_format=torch.channels_last)


def _he(rng: np.random.Generator, cout: int, cin: int, k: int) -> torch.Tensor:
    return oihw(rng.standard_normal((cout, cin, k, k), dtype=np.float32)
                * np.float32((2.0 / (cin * k * k)) ** 0.5))


def _bn(n: int) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones(n), "bias": torch.zeros(n)}


def _init_bottleneck(rng: np.random.Generator, inplanes: int, planes: int, stride: int) -> Params:
    p = {
        "conv1": _he(rng, planes, inplanes, 1), "bn1": _bn(planes),
        "conv2": _he(rng, planes, planes, 3), "bn2": _bn(planes),
        "conv3": _he(rng, planes * 4, planes, 1), "bn3": _bn(planes * 4),
    }
    if stride > 1 or inplanes != planes * 4:
        p["downsample"] = {"conv": _he(rng, planes * 4, inplanes, 1), "bn": _bn(planes * 4)}
    return p


def init_resnet_params(rng: np.random.Generator, cfg,
                       dtype: torch.dtype = torch.float32) -> Params:
    """Random ResNet tower parameters from a numpy generator: He-normal
    convs, identity BN, the attention pool at std ``embed ** -0.5``."""
    width = cfg.vision_width
    params: Params = {"stem": {
        "conv1": _he(rng, width // 2, 3, 3), "bn1": _bn(width // 2),
        "conv2": _he(rng, width // 2, width // 2, 3), "bn2": _bn(width // 2),
        "conv3": _he(rng, width, width // 2, 3), "bn3": _bn(width),
    }}
    inplanes = width
    for i, (blocks, stride) in enumerate(zip(cfg.vision_layers, LAYER_STRIDES)):
        planes = width * 2 ** i
        layer: List[Params] = []
        for j in range(blocks):
            layer.append(_init_bottleneck(rng, inplanes, planes, stride if j == 0 else 1))
            inplanes = planes * 4
        params[f"layer{i + 1}"] = layer

    embed_c = width * 32
    std = np.float32(embed_c ** -0.5)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * std)

    params["attnpool"] = {
        "positional_embedding": randn((cfg.image_resolution // 32) ** 2 + 1, embed_c),
        "wq": randn(embed_c, embed_c), "wk": randn(embed_c, embed_c),
        "wv": randn(embed_c, embed_c), "wo": randn(embed_c, cfg.embed_dim),
        "bq": torch.zeros(embed_c), "bk": torch.zeros(embed_c),
        "bv": torch.zeros(embed_c), "bo": torch.zeros(cfg.embed_dim),
    }

    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v) for v in tree]
        return tree.to(dtype)

    return cast(params)
