"""CLIP container: backbone registry, init, apply, weight import (counterpart
of ``protoclip_tpu/models/clip.py``).

The same 7 OpenAI backbones, with the architecture taken from the registry
or inferred from a state dict's tensor shapes: the ViT towers
(``models/vit.py``) and the ModifiedResNet towers (``models/resnet.py``).
Beside them the port's own registry (:data:`PORT_BACKBONE_CONFIGS`) holds
EVA02-CLIP-L/14-336, whose image tower is EVA02's, and EVA02-CLIP-bigE-14-plus,
whose image tower is EVA-CLIP's post-norm one (both ``models/eva.py``); both
text towers are OpenAI's with the exact GELU, read from EVA-CLIP's
state-dict layout.  K3, the W8A8 serving mode, runs neither.

Parameters are nested dicts of tensors.  Transformer blocks are a list of
per-layer dicts whose attention carries the fused ``wqkv`` (D, 3D) and
``bqkv`` (3D,), built once here rather than on every call.  The compute
dtype defaults to bfloat16, with LayerNorm affine and ``logit_scale`` kept
in fp32, as are a ResNet's folded BatchNorm ``scale``/``bias``.

The W8A8 serving mode (``$PROTOCLIP_INT8``) adds, beside each tower's
``blocks``, a ``blocks_q`` list of int8 layers made once at load
(:func:`quantize_for_serving`).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import zipfile
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from protoclip_tpu_torch.device import DeviceLike, resolve_device
from protoclip_tpu_torch.models import eva as _eva
from protoclip_tpu_torch.models import resnet as _resnet
from protoclip_tpu_torch.models import text as _text
from protoclip_tpu_torch.models import vit as _vit
from protoclip_tpu_torch.obs.profiler import span
from protoclip_tpu_torch.ops.kernels import int8_enabled, quantize_block
from protoclip_tpu_torch.ops.proto import l2_normalize

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """Architecture hyperparameters (ref ``clip/model.py:241-295``)."""

    name: str
    embed_dim: int
    image_resolution: int
    vision_layers: Union[int, Tuple[int, int, int, int]]
    vision_width: int
    vision_patch_size: Optional[int]  # None for ResNet towers
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_layers: int = 12
    # Head-count overrides for non-standard widths (None = OpenAI's
    # 64-dims-per-head rule).
    n_vision_heads: Optional[int] = None
    n_text_heads: Optional[int] = None
    # The image tower's block: OpenAI's ("clip"), EVA02's ("eva02", with
    # its SwiGLU width and the grid its RoPE was pretrained at) or EVA-CLIP's
    # post-norm block ("eva_postnorm", with its MLP width); the text MLP's
    # activation ("quick_gelu", or "gelu" in EVA02-CLIP).
    vision_block: str = "clip"
    vision_mlp_width: Optional[int] = None
    rope_pt_grid: Optional[int] = None
    text_act: str = "quick_gelu"

    @property
    def is_vit(self) -> bool:
        return self.vision_patch_size is not None

    @property
    def is_eva(self) -> bool:
        """An EVA-CLIP image tower (``models/eva.py``), of either block."""
        return self.vision_block in (_eva.EVA02, _eva.POSTNORM)

    @property
    def vision_heads(self) -> int:
        return self.n_vision_heads or self.vision_width // 64

    @property
    def vision_heads_resnet(self) -> int:
        return self.n_vision_heads or self.vision_width * 32 // 64

    @property
    def transformer_heads(self) -> int:
        return self.n_text_heads or self.transformer_width // 64


BACKBONE_CONFIGS: Dict[str, CLIPConfig] = {
    "RN50": CLIPConfig("RN50", 1024, 224, (3, 4, 6, 3), 64, None),
    "RN101": CLIPConfig("RN101", 512, 224, (3, 4, 23, 3), 64, None),
    "RN50x4": CLIPConfig("RN50x4", 640, 288, (4, 6, 10, 6), 80, None, transformer_width=640),
    "RN50x16": CLIPConfig(
        "RN50x16", 768, 384, (6, 8, 18, 8), 96, None, transformer_width=768
    ),
    "ViT-B/32": CLIPConfig("ViT-B/32", 512, 224, 12, 768, 32),
    "ViT-B/16": CLIPConfig("ViT-B/16", 512, 224, 12, 768, 16),
    "ViT-L/14": CLIPConfig("ViT-L/14", 768, 224, 24, 1024, 14, transformer_width=768),
}


# Backbones of the port alone, kept apart from the JAX package's registry.
# EVA02-CLIP-L/14-336 (baaivision/EVA EVA-CLIP model_configs/
# EVA02-CLIP-L-14-336.json): vision 1024 / 24 / 16 heads of 64, patch 14 at
# 336 px, SwiGLU hidden int(1024 * 2.6667) = 2730, RoPE pretrained at
# pt_hw_seq_len 16; text 768 / 12 / 12 with nn.GELU; embed 768.
# EVA02-CLIP-bigE-14-plus (model_configs/EVA02-CLIP-bigE-14-plus.json):
# vision 1792 / 64 / 16 heads of 112 (head_width), patch 14 at 224 px,
# postnorm, MLP int(1792 * 8.571428571428571) = 15360 with nn.GELU; text
# 1280 / 32 / 20 with nn.GELU; embed 1024.
PORT_BACKBONE_CONFIGS: Dict[str, CLIPConfig] = {
    "EVA02-CLIP-L-14-336": CLIPConfig(
        "EVA02-CLIP-L-14-336", 768, 336, 24, 1024, 14, transformer_width=768,
        vision_block=_eva.EVA02, vision_mlp_width=2730, rope_pt_grid=16, text_act="gelu"),
    "EVA02-CLIP-bigE-14-plus": CLIPConfig(
        "EVA02-CLIP-bigE-14-plus", 1024, 224, 64, 1792, 14, transformer_width=1280,
        transformer_layers=32, n_vision_heads=16, vision_block=_eva.POSTNORM,
        vision_mlp_width=15360, text_act="gelu"),
}


def available_backbones() -> list:
    return list(BACKBONE_CONFIGS)


def backbone_config(name: str) -> Optional[CLIPConfig]:
    """A backbone of either registry by name, or None."""
    return BACKBONE_CONFIGS.get(name) or PORT_BACKBONE_CONFIGS.get(name)


# -- apply ------------------------------------------------------------------


def encode_image(params: Params, images: torch.Tensor, cfg: CLIPConfig,
                 int8: Optional[bool] = None) -> torch.Tensor:
    """(B, H, W, 3) preprocessed images -> (B, embed_dim) features.  ``int8``
    picks a ViT's block mode (None: ``$PROTOCLIP_INT8``); a ResNet tower
    has no transformer blocks."""
    if cfg.is_eva:
        return _eva.apply_eva(params["visual"], images, cfg, int8=int8)
    if cfg.is_vit:
        return _vit.apply_vit(params["visual"], images, cfg, int8=int8)
    return _resnet.apply_resnet(params["visual"], images, cfg)


def encode_text(params: Params, tokens: torch.Tensor, cfg: CLIPConfig,
                int8: Optional[bool] = None) -> torch.Tensor:
    """(B, context) token ids -> (B, embed_dim) features.  ``int8`` picks
    the block mode as in :func:`encode_image`."""
    return _text.apply_text(params["text"], tokens, cfg, int8=int8)


def clip_forward(params: Params, images: torch.Tensor, tokens: torch.Tensor,
                 cfg: CLIPConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Contrastive logits (per image, per text), as ``clip/model.py:356-370``."""
    img = l2_normalize(encode_image(params, images, cfg).float())
    txt = l2_normalize(encode_text(params, tokens, cfg).float())
    logits_per_image = params["logit_scale"].float().exp() * img @ txt.T
    return logits_per_image, logits_per_image.T


# -- init -------------------------------------------------------------------


def init_clip_params(rng: np.random.Generator, cfg: CLIPConfig,
                     dtype: torch.dtype = torch.float32) -> Params:
    """Random CLIP parameters from a numpy generator (CPU tensors).  An
    EVA-CLIP tower is drawn in EVA-CLIP's layout and converted
    (:func:`models.eva.visual_from_state_dict`)."""
    if cfg.is_eva:
        visual = cast_params(_eva.visual_from_state_dict(
            _eva.random_visual_state_dict(rng, cfg), cfg), dtype)
    else:
        init_visual = _vit.init_vit_params if cfg.is_vit else _resnet.init_resnet_params
        visual = init_visual(rng, cfg, dtype)
    return {
        "visual": visual,
        "text": _text.init_text_params(rng, cfg, dtype),
        "logit_scale": torch.tensor(np.log(1 / 0.07), dtype=torch.float32),
    }


# -- parameters carried from other layouts ----------------------------------


def _t(x) -> torch.Tensor:
    # a C-ordered copy whatever the source's layout (a transposed view keeps
    # its F order under np.array's default): the card's kernels take
    # contiguous weights
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))


def _ln(scale, bias) -> Dict[str, torch.Tensor]:
    return {"scale": _t(scale), "bias": _t(bias)}


def _blocks_from_jax(stacked: Dict) -> list:
    """Stacked ``(n_layers, ...)`` JAX block leaves -> per-layer port blocks."""
    attn, mlp = stacked["attn"], stacked["mlp"]
    return [
        {
            "ln_1": _ln(stacked["ln_1"]["scale"][i], stacked["ln_1"]["bias"][i]),
            "attn": {
                "wqkv": _t(np.concatenate([attn["wq"][i], attn["wk"][i], attn["wv"][i]], axis=1)),
                "bqkv": _t(np.concatenate([attn["bq"][i], attn["bk"][i], attn["bv"][i]])),
                "wo": _t(attn["wo"][i]),
                "bo": _t(attn["bo"][i]),
            },
            "ln_2": _ln(stacked["ln_2"]["scale"][i], stacked["ln_2"]["bias"][i]),
            "mlp": {k: _t(mlp[k][i]) for k in ("w_fc", "b_fc", "w_proj", "b_proj")},
        }
        for i in range(len(stacked["ln_1"]["scale"]))
    ]


def _qblocks_from_jax(stacked: Dict) -> list:
    """A stacked JAX ``blocks_q`` tree (``quantize_stacked_blocks``: int8
    weights ``(n_layers, in, out)``, scales ``(n_layers, 1, out)``) -> the
    port's int8 layers (:func:`ops.kernels.quantize_block`): weights
    ``(out, in)``, scales and biases flat."""
    def layer(i):
        q = {}
        for key, value in stacked.items():
            a = np.asarray(value[i])
            if key.startswith("w"):
                q[key] = torch.from_numpy(np.ascontiguousarray(a.T)).to(torch.int8)
            else:
                q[key] = _t(a.reshape(-1))
        return q

    return [layer(i) for i in range(len(stacked["wqkv"]))]


def _vit_from_jax(vis: Dict) -> Params:
    return {
        "patch_embed": _t(vis["patch_embed"]),
        "class_embedding": _t(vis["class_embedding"]),
        "positional_embedding": _t(vis["positional_embedding"]),
        "ln_pre": _ln(vis["ln_pre"]["scale"], vis["ln_pre"]["bias"]),
        "blocks": _blocks_from_jax(vis["blocks"]),
        "ln_post": _ln(vis["ln_post"]["scale"], vis["ln_post"]["bias"]),
        "proj": _t(vis["proj"]),
    }


def _resnet_from_jax(vis: Dict) -> Params:
    def walk(tree, key=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if key.startswith("conv"):  # HWIO -> OIHW
            return _resnet.oihw(np.asarray(tree, np.float32).transpose(3, 2, 0, 1))
        return _t(tree)

    def index(tree, j):
        if isinstance(tree, dict):
            return {k: index(v, j) for k, v in tree.items()}
        return np.asarray(tree)[j]

    out = {"stem": walk(vis["stem"]), "attnpool": walk(vis["attnpool"])}
    for i in range(1, len(_resnet.LAYER_STRIDES) + 1):
        layer = vis[f"layer{i}"]
        rest = layer.get("rest")
        n_rest = 0 if rest is None else len(rest["conv1"])
        out[f"layer{i}"] = [walk(layer["block0"])] + [walk(index(rest, j)) for j in range(n_rest)]
    return out


def params_from_jax(np_params: Params, cfg: CLIPConfig, dtype: torch.dtype = torch.float32,
                    device: DeviceLike = None) -> Params:
    """The JAX package's CLIP parameters, as numpy arrays, -> the port's.

    ``np_params`` is ``init_clip_params``, ``convert_clip_state_dict`` or
    ``quantize_for_serving`` output of ``protoclip_tpu.models.clip`` after
    ``jax.tree_util.tree_map(np.asarray, ...)``.  Block leaves are
    un-stacked, ``wqkv``/``bqkv`` built, a tower's ``blocks_q`` carried
    into the port's int8 layout, and the result cast as :func:`cast_params`
    does.  A ResNet tower's HWIO conv kernels become OIHW and each layer's
    stacked ``rest`` is un-stacked into the layer's list after ``block0``.
    """
    vis, txt = np_params["visual"], np_params["text"]
    params = {
        "visual": _vit_from_jax(vis) if cfg.is_vit else _resnet_from_jax(vis),
        "text": {
            "token_embedding": _t(txt["token_embedding"]),
            "positional_embedding": _t(txt["positional_embedding"]),
            "blocks": _blocks_from_jax(txt["blocks"]),
            "ln_final": _ln(txt["ln_final"]["scale"], txt["ln_final"]["bias"]),
            "text_projection": _t(txt["text_projection"]),
        },
        "logit_scale": _t(np_params["logit_scale"]),
    }
    for tower, src in (("visual", vis), ("text", txt)):
        if "blocks_q" in src:
            params[tower]["blocks_q"] = _qblocks_from_jax(src["blocks_q"])
    return to_device(cast_params(params, dtype), resolve_device(device))


# -- OpenAI state dicts -----------------------------------------------------


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _count_layers(sd: Dict[str, Any], prefix: str, suffix: str) -> int:
    return len({k.split(".")[prefix.count(".") + 1] for k in sd
                if k.startswith(prefix + ".") and k.endswith(suffix)})


def _infer_eva_config(sd: Dict[str, Any]) -> CLIPConfig:
    """EVA-CLIP's layout (``visual.patch_embed``, ``visual.blocks``,
    ``text.*``), of EVA02's sub-LN block (separate q/k/v projections, a
    SwiGLU ``mlp.w1/w2/w3``) or of the post-norm block (a fused
    ``attn.qkv``, ``mlp.fc1/fc2``).  What no shape says comes from the
    registered backbone of the same shapes: EVA02's RoPE pretraining grid
    (else EVA02-CLIP's 16), and the post-norm tower's head count, and that
    its blocks are post-norm at all (EVA-CLIP's pre-norm towers have the
    same keys), so a post-norm state dict of no registered shape raises."""
    if "visual.blocks.0.attn.q_proj.weight" in sd and "visual.blocks.0.mlp.w3.weight" in sd:
        block, mlp_key = _eva.EVA02, "visual.blocks.0.mlp.w1.weight"
    elif "visual.blocks.0.attn.qkv.weight" in sd and "visual.blocks.0.mlp.fc1.weight" in sd:
        block, mlp_key = _eva.POSTNORM, "visual.blocks.0.mlp.fc1.weight"
    else:
        raise ValueError("an EVA-CLIP state dict with neither EVA02's sub-LN block (separate "
                         "q/k/v projections, a SwiGLU mlp.w1/w2/w3) nor the post-norm block (a "
                         "fused attn.qkv, mlp.fc1/fc2): no other EVA-CLIP block is supported")
    pe = sd["visual.patch_embed.proj.weight"]
    width, patch = int(pe.shape[0]), int(pe.shape[-1])
    resolution = patch * round((sd["visual.pos_embed"].shape[-2] - 1) ** 0.5)
    layers = _count_layers(sd, "visual.blocks", ".norm1.weight")
    mlp = int(sd[mlp_key].shape[0])
    known = next((c for c in PORT_BACKBONE_CONFIGS.values()
                  if (c.vision_block, c.vision_width, c.vision_layers, c.vision_patch_size,
                      c.image_resolution, c.vision_mlp_width)
                  == (block, width, layers, patch, resolution, mlp)), None)
    if block == _eva.POSTNORM and known is None:
        raise ValueError(f"an EVA-CLIP state dict with a fused attn.qkv and mlp.fc1/fc2 at width "
                         f"{width}, {layers} blocks, MLP {mlp}, patch {patch} at {resolution} px "
                         "matches no registered post-norm backbone: its keys say neither that "
                         "its blocks are post-norm nor its head count (PORT_BACKBONE_CONFIGS)")
    return CLIPConfig(
        known.name if known else "custom",
        int(sd["visual.head.weight"].shape[0]),
        resolution,
        layers,
        width,
        patch,
        int(sd["text.positional_embedding"].shape[0]),
        int(sd["text.token_embedding.weight"].shape[0]),
        int(sd["text.ln_final.weight"].shape[0]),
        _count_layers(sd, "text.transformer.resblocks", ".ln_1.weight"),
        n_vision_heads=known.n_vision_heads if known else None,
        vision_block=block,
        vision_mlp_width=mlp,
        rope_pt_grid=(None if block == _eva.POSTNORM
                      else known.rope_pt_grid if known else _eva.DEFAULT_PT_GRID),
        text_act="gelu",
    )


def infer_config_from_state_dict(sd: Dict[str, Any]) -> CLIPConfig:
    """Shape-based architecture inference (ref ``clip/model.py:397-420``);
    EVA-CLIP's layout by :func:`_infer_eva_config`."""
    if "visual.patch_embed.proj.weight" in sd:
        return _infer_eva_config(sd)
    if "visual.proj" in sd:
        vision_width = sd["visual.conv1.weight"].shape[0]
        vision_layers = len(
            [k for k in sd if k.startswith("visual.") and k.endswith(".attn.in_proj_weight")]
        )
        patch = int(sd["visual.conv1.weight"].shape[-1])
        grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
        image_resolution = patch * grid
    else:
        vision_layers = tuple(
            len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{b}")})
            for b in (1, 2, 3, 4)
        )
        vision_width = sd["visual.layer1.0.conv1.weight"].shape[0]
        out_width = round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
        patch = None
        image_resolution = out_width * 32
    name = next(
        (n for n, c in BACKBONE_CONFIGS.items()
         if c.vision_layers == vision_layers and c.vision_width == vision_width
         and c.vision_patch_size == patch),
        "custom",
    )
    return CLIPConfig(
        name,
        int(sd["text_projection"].shape[1]),
        int(image_resolution),
        vision_layers,
        int(vision_width),
        patch,
        int(sd["positional_embedding"].shape[0]),
        int(sd["token_embedding.weight"].shape[0]),
        int(sd["ln_final.weight"].shape[0]),
        len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks")}),
    )


def _blocks_from_state_dict(sd: Dict[str, np.ndarray], prefix: str, n_layers: int) -> list:
    """torch resblocks -> port blocks: ``in_proj_weight`` (3D, D) transposed
    is exactly the fused (D, 3D) ``wqkv`` with columns [q | k | v]."""
    blocks = []
    for i in range(n_layers):
        p = f"{prefix}.resblocks.{i}"
        blocks.append({
            "ln_1": _ln(sd[f"{p}.ln_1.weight"], sd[f"{p}.ln_1.bias"]),
            "attn": {
                "wqkv": _t(sd[f"{p}.attn.in_proj_weight"].T),
                "bqkv": _t(sd[f"{p}.attn.in_proj_bias"]),
                "wo": _t(sd[f"{p}.attn.out_proj.weight"].T),
                "bo": _t(sd[f"{p}.attn.out_proj.bias"]),
            },
            "ln_2": _ln(sd[f"{p}.ln_2.weight"], sd[f"{p}.ln_2.bias"]),
            "mlp": {
                "w_fc": _t(sd[f"{p}.mlp.c_fc.weight"].T),
                "b_fc": _t(sd[f"{p}.mlp.c_fc.bias"]),
                "w_proj": _t(sd[f"{p}.mlp.c_proj.weight"].T),
                "b_proj": _t(sd[f"{p}.mlp.c_proj.bias"]),
            },
        })
    return blocks


def _fold_bn(sd: Dict[str, np.ndarray], prefix: str, eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """Frozen BatchNorm statistics folded in fp32: ``y = x * scale + bias``."""
    gamma, beta = sd[f"{prefix}.weight"], sd[f"{prefix}.bias"]
    mean, var = sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"]
    scale = gamma / np.sqrt(var + eps)
    return {"scale": _t(scale), "bias": _t(beta - mean * scale)}


def _convert_bottleneck(sd: Dict[str, np.ndarray], p: str) -> Params:
    out = {
        "conv1": _resnet.oihw(sd[f"{p}.conv1.weight"]), "bn1": _fold_bn(sd, f"{p}.bn1"),
        "conv2": _resnet.oihw(sd[f"{p}.conv2.weight"]), "bn2": _fold_bn(sd, f"{p}.bn2"),
        "conv3": _resnet.oihw(sd[f"{p}.conv3.weight"]), "bn3": _fold_bn(sd, f"{p}.bn3"),
    }
    if f"{p}.downsample.0.weight" in sd:
        out["downsample"] = {"conv": _resnet.oihw(sd[f"{p}.downsample.0.weight"]),
                             "bn": _fold_bn(sd, f"{p}.downsample.1")}
    return out


def _convert_vit(sd: Dict[str, np.ndarray], cfg: CLIPConfig) -> Params:
    patch = cfg.vision_patch_size
    # OIHW (width, 3, P, P) -> (P, P, 3, width) -> (P*P*3, width): the
    # (py, px, c) order of vit.patchify
    pe = sd["visual.conv1.weight"].transpose(2, 3, 1, 0).reshape(patch * patch * 3, -1)
    return {
        "patch_embed": _t(pe),
        "class_embedding": _t(sd["visual.class_embedding"]),
        "positional_embedding": _t(sd["visual.positional_embedding"]),
        "ln_pre": _ln(sd["visual.ln_pre.weight"], sd["visual.ln_pre.bias"]),
        "blocks": _blocks_from_state_dict(sd, "visual.transformer", cfg.vision_layers),
        "ln_post": _ln(sd["visual.ln_post.weight"], sd["visual.ln_post.bias"]),
        "proj": _t(sd["visual.proj"]),
    }


def _convert_resnet(sd: Dict[str, np.ndarray], cfg: CLIPConfig) -> Params:
    """Conv kernels stay OIHW; BatchNorm is folded (JAX ``clip.py:263-328``)."""
    visual: Params = {"stem": {}}
    for i in (1, 2, 3):
        visual["stem"][f"conv{i}"] = _resnet.oihw(sd[f"visual.conv{i}.weight"])
        visual["stem"][f"bn{i}"] = _fold_bn(sd, f"visual.bn{i}")
    for li, blocks in enumerate(cfg.vision_layers):
        visual[f"layer{li + 1}"] = [
            _convert_bottleneck(sd, f"visual.layer{li + 1}.{j}") for j in range(blocks)
        ]
    pool = "visual.attnpool"
    visual["attnpool"] = {"positional_embedding": _t(sd[f"{pool}.positional_embedding"])}
    for name, proj in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "c_proj")):
        visual["attnpool"][f"w{name}"] = _t(sd[f"{pool}.{proj}.weight"].T)
        visual["attnpool"][f"b{name}"] = _t(sd[f"{pool}.{proj}.bias"])
    return visual


def convert_clip_state_dict(sd: Dict[str, Any], cfg: Optional[CLIPConfig] = None
                            ) -> Tuple[CLIPConfig, Params]:
    """OpenAI CLIP torch state dict, or EVA-CLIP's, -> (config, fp32 CPU
    parameters)."""
    sd = {k: _np(v) for k, v in sd.items()
          if k not in ("input_resolution", "context_length", "vocab_size")}
    cfg = cfg or infer_config_from_state_dict(sd)
    if cfg.is_eva:
        return cfg, _convert_eva(sd, cfg)
    params: Params = {
        "visual": _convert_vit(sd, cfg) if cfg.is_vit else _convert_resnet(sd, cfg),
        "text": {
            "token_embedding": _t(sd["token_embedding.weight"]),
            "positional_embedding": _t(sd["positional_embedding"]),
            "blocks": _blocks_from_state_dict(sd, "transformer", cfg.transformer_layers),
            "ln_final": _ln(sd["ln_final.weight"], sd["ln_final.bias"]),
            "text_projection": _t(sd["text_projection"]),
        },
        "logit_scale": _t(sd["logit_scale"]),
    }
    return cfg, params


def _eva_text(sd: Dict[str, np.ndarray], cfg: CLIPConfig) -> Params:
    """EVA-CLIP's ``text.*``: OpenAI's text tower under the ``text.``
    prefix."""
    t = "text."
    return {
        "token_embedding": _t(sd[t + "token_embedding.weight"]),
        "positional_embedding": _t(sd[t + "positional_embedding"]),
        "blocks": _blocks_from_state_dict(sd, t + "transformer", cfg.transformer_layers),
        "ln_final": _ln(sd[t + "ln_final.weight"], sd[t + "ln_final.bias"]),
        "text_projection": _t(sd[t + "text_projection"]),
    }


def _convert_eva(sd: Dict[str, np.ndarray], cfg: CLIPConfig) -> Params:
    """EVA-CLIP: ``visual.*`` to the EVA02 tower; ``text.*``, OpenAI's text
    tower under the ``text.`` prefix; ``logit_scale``."""
    return {"visual": _eva.visual_from_state_dict(sd, cfg), "text": _eva_text(sd, cfg),
            "logit_scale": _t(sd["logit_scale"])}


def _convert_eva_postnorm(sd: Dict[str, Any], cfg: CLIPConfig, dtype: torch.dtype,
                          device: torch.device) -> Params:
    """EVA-CLIP's post-norm layout straight into ``dtype`` on ``device``
    (cast as :func:`cast_params` casts), :func:`load_clip`'s converter for
    it: the image tower block by block
    (:func:`models.eva.postnorm_visual_from_state_dict`), so that no fp32
    copy of it is held whole; the text tower (0.69 B parameters in bigE)
    through fp32 as :func:`convert_clip_state_dict` converts it."""
    text = {k: _np(v) for k, v in sd.items() if k.startswith("text.")}
    return {"visual": _eva.postnorm_visual_from_state_dict(sd, cfg, dtype, device),
            "text": to_device(cast_params(_eva_text(text, cfg), dtype), device),
            "logit_scale": _t(_np(sd["logit_scale"])).to(device)}


# LayerNorm affine, the EVA02 block's sub-LNs and its RoPE tables stay fp32
_FP32_KEYS = ("ln_1", "ln_2", "ln_pre", "ln_post", "ln_final", "ln_inner", "ln_ffn", "rope")


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """Cast weights to a compute dtype, keeping LayerNorm affine, the
    folded BatchNorm (``bn*``) and ``logit_scale`` in fp32 (they are
    consumed in fp32 anyway).  The int8
    layers of ``blocks_q`` pass through untouched: their int8 values and
    fp32 scales are exact as they are."""

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path) for v in tree]
        if "blocks_q" in path:
            return tree
        keep = (any(p in _FP32_KEYS or p.startswith("bn") for p in path)
                or path[-1:] == ("logit_scale",))
        return tree.float() if keep else tree.to(dtype)

    return walk(params, ())


def quantize_for_serving(params: Params) -> Params:
    """Attach a ``blocks_q`` list of int8 layers (:func:`ops.kernels.
    quantize_block`) beside each tower's ``blocks``, as
    ``protoclip_tpu.models.clip.quantize_for_serving`` (``clip.py:353-373``)
    does.  The towers pick it up when ``$PROTOCLIP_INT8`` is on, so the
    weights are quantized once, here, and not on every encode.  An
    EVA-CLIP tower (its biased patch embedding) raises: K3 has neither
    EVA02's block nor the post-norm one."""
    if "patch_bias" in params.get("visual", {}):
        raise ValueError("the W8A8 serving mode (K3, $PROTOCLIP_INT8) has no EVA-CLIP block "
                         "(EVA02's or the post-norm one): run EVA02-CLIP backbones in bf16")
    out = dict(params)
    for tower in ("visual", "text"):
        sub = params.get(tower)
        if isinstance(sub, dict) and "blocks" in sub:
            out[tower] = {**sub, "blocks_q": [quantize_block(b) for b in sub["blocks"]]}
    return out


def _maybe_quantize(params: Params, int8: Optional[bool]) -> Params:
    """The serving mode's int8 layers, made at load when it is on (``int8``
    None: ``$PROTOCLIP_INT8``)."""
    if int8 is None:
        int8 = int8_enabled()
    return quantize_for_serving(params) if int8 else params


def to_device(params: Params, device: torch.device) -> Params:
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [to_device(v, device) for v in params]
    return params.to(device)


# -- weight files -----------------------------------------------------------

_WEIGHT_ENV = "PROTOCLIP_WEIGHTS_DIR"
_WEIGHT_DIRS = (os.path.expanduser("~/.cache/clip"),)
_WEIGHT_FILENAMES = {
    "RN50": "RN50.pt",
    "RN101": "RN101.pt",
    "RN50x4": "RN50x4.pt",
    "RN50x16": "RN50x16.pt",
    "ViT-B/32": "ViT-B-32.pt",
    "ViT-B/16": "ViT-B-16.pt",
    "ViT-L/14": "ViT-L-14.pt",
}


def find_weights(backbone: str) -> Optional[str]:
    fname = _WEIGHT_FILENAMES.get(backbone, backbone)
    dirs = ([os.environ[_WEIGHT_ENV]] if os.environ.get(_WEIGHT_ENV) else []) + list(_WEIGHT_DIRS)
    for d in dirs:
        cand = os.path.join(d, fname)
        if os.path.exists(cand):
            return cand
    return None


def _is_torchscript(path: str) -> bool:
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as zf:
        return any(n.endswith("/constants.pkl") for n in zf.namelist())


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """An OpenAI release: a TorchScript archive's ``state_dict()``, or a
    plain state dict read with ``torch.load(weights_only=True)``."""
    if _is_torchscript(path):
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"{path} did not contain a state dict")
    # a DataParallel 'module.' prefix is stripped per key: extra buffers
    # registered outside the wrapped module keep their names
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}


def load_clip(backbone: str, weights_path: Optional[str] = None,
              dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None,
              seed: int = 0, int8: Optional[bool] = None) -> Tuple[CLIPConfig, Params]:
    """Load a CLIP backbone onto ``device`` (default: the card).

    Resolution order: explicit ``weights_path`` -> ``$PROTOCLIP_WEIGHTS_DIR``
    / ``~/.cache/clip`` -> with ``$PROTOCLIP_AUTO_DOWNLOAD`` on, the pinned
    release (``io/download.py``; a failed checksum raises, any other
    failure falls through) -> random initialization from the numpy ``seed``
    (with a warning on stderr: classification then carries no semantics),
    unless ``$PROTOCLIP_STRICT_WEIGHTS`` forbids it.  ``backbone`` names an
    entry of either registry; a weights file's own layout and shapes decide
    its architecture (OpenAI's or EVA-CLIP's), and its conversion is the
    span ``load.convert`` (rows: the state dict's entries, bytes: theirs).  In the W8A8 mode
    (``int8``; None reads ``$PROTOCLIP_INT8``) the transformer stacks are
    quantized once here, from the weights in ``dtype``
    (:func:`quantize_for_serving`).
    """
    dev = resolve_device(device)
    path = weights_path or find_weights(backbone)
    if path is None and os.environ.get("PROTOCLIP_AUTO_DOWNLOAD", "0").lower() in (
            "1", "true", "on"):
        # opt-in: deployments without egress must not stall on timeouts
        from protoclip_tpu_torch.io.download import MODEL_URLS, ChecksumError, download_weights

        if backbone in MODEL_URLS:
            try:
                path = download_weights(backbone)
            except ChecksumError:
                raise  # a tampered or corrupt artifact: never serve random weights
            except Exception as exc:  # noqa: BLE001 — network-dependent
                print(f"[protoclip_tpu_torch] weight download failed ({exc}); "
                      "falling back to random init", file=sys.stderr)
    if path is not None:
        sd = load_state_dict(path)
        with span("load.convert", rows=len(sd),
                  nbytes=sum(v.numel() * v.element_size() for v in sd.values()
                             if isinstance(v, torch.Tensor))):
            cfg = infer_config_from_state_dict(sd)
            if cfg.vision_block == _eva.POSTNORM:
                return cfg, _maybe_quantize(_convert_eva_postnorm(sd, cfg, dtype, dev), int8)
            cfg, params = convert_clip_state_dict(sd)
        return cfg, _maybe_quantize(to_device(cast_params(params, dtype), dev), int8)

    if os.environ.get("PROTOCLIP_STRICT_WEIGHTS", "0").lower() in ("1", "true", "on"):
        raise FileNotFoundError(
            f"no weights found for {backbone!r} and $PROTOCLIP_STRICT_WEIGHTS "
            f"forbids random initialization (set ${_WEIGHT_ENV} or pass weights_path)"
        )
    cfg = backbone_config(backbone)
    if cfg is None:
        raise ValueError(
            f"unknown backbone {backbone!r} and no weights file to infer an "
            f"architecture from; known: {sorted(BACKBONE_CONFIGS) + sorted(PORT_BACKBONE_CONFIGS)}"
        )
    print(
        f"[protoclip_tpu_torch] WARNING: no weights found for {backbone!r} "
        f"(set ${_WEIGHT_ENV}); using random initialization.",
        file=sys.stderr,
    )
    params = init_clip_params(np.random.default_rng(seed), cfg)
    return cfg, _maybe_quantize(to_device(cast_params(params, dtype), dev), int8)
