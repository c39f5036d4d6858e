"""The image towers of the EVA02-CLIP backbones (EVA-CLIP, Sun et al.
2023, arXiv:2303.15389; the block of EVA-02, Fang et al. 2023,
arXiv:2303.11331; code: baaivision/EVA ``EVA-CLIP/rei/eva_clip/
eva_vit_model.py``, ``rope.py``).  The port's own: the JAX package has no
EVA tower.

Against OpenAI's ViT (``models/vit.py``): the patch embedding has a bias,
there is no ``ln_pre``, every LayerNorm has eps 1e-6, and each block
(``ops.kernels.fused_eva_block``) turns q and k of every patch token by a
2D rotary embedding, normalises the attention output before its
projection, and runs a SwiGLU MLP whose hidden is normalised before its
down-projection.  The head is a biased linear map of the normalised class
token.

Parameters, built once at load from EVA-CLIP's state-dict layout
(:func:`visual_from_state_dict`): the fused ``wqkv`` (D, 3D) with ``bqkv`` =
[bq, 0, bv] (k has no bias); ``w12`` (D, 2Hp), w1 and w2 interleaved by
column (2i: w1's column i, 2i+1: w2's) so that one accumulator pair of the
SwiGLU GEMM holds a hidden unit's gate and value, with the hidden width H
padded with zero columns to Hp, a multiple of 8 (the GEMMs' TMA rows are
whole 16-byte pieces: 2730 -> 2736 in EVA02-L); ``w3`` (Hp, D), its padded
rows zero; ``ln_ffn`` over the true H; and the RoPE tables ``rope.cos`` /
``rope.sin`` (grid^2, head_dim) in fp32, computed here from the grid and
the registry's pretraining grid (``CLIPConfig.rope_pt_grid``).

EVA02-CLIP-bigE's tower (``vision_block`` :data:`POSTNORM`; EVA-CLIP's
``Block`` with ``postnorm``, no ``rope``, ``subln`` or ``naiveswiglu``)
shares the front end and the head, and each block (``ops.kernels.
fused_eva_postnorm_block``) normalises the output of its attention and of
its MLP before adding it to the residual: x + LN1(Attn(x)), then x +
LN2(MLP(x)).  The attention is one fused ``attn.qkv`` with q and v biases
and no inner LN; the MLP is ``fc1``, the exact GELU, ``fc2``.  Its
parameters take K2's layout (``wqkv``/``bqkv`` = [bq, 0, bv], ``wo``/
``bo``, ``ln_1``, ``ln_2``, ``w_fc``/``b_fc``, ``w_proj``/``b_proj``),
built block by block straight into the served dtype on the target device
(:func:`postnorm_visual_from_state_dict`), so no fp32 copy of the whole
tower is ever held.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from protoclip_tpu_torch.models.layers import eva_postnorm_transformer, eva_transformer
from protoclip_tpu_torch.models.vit import patchify
from protoclip_tpu_torch.ops.kernels import EVA_LN_EPS, PIECE, int8_enabled
from protoclip_tpu_torch.ops.layernorm import layer_norm

Params = Dict[str, object]
ROPE_THETA = 10000.0
# the pretraining grid of every EVA02-CLIP vision config (``pt_hw_seq_len``
# 16, 224 px / 14): taken for a state dict of no registered shape
DEFAULT_PT_GRID = 16
TABLE_ATOL = 1e-5  # a checkpoint's RoPE buffers against the recomputed tables
EVA02, POSTNORM = "eva02", "eva_postnorm"  # CLIPConfig.vision_block of the two towers


def padded_hidden(h: int) -> int:
    """The SwiGLU hidden width rounded up to whole 16-byte pieces of bf16."""
    return -(-h // PIECE) * PIECE


def rope_tables(grid: int, pt_grid: int, head_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """EVA-CLIP's ``VisionRotaryEmbeddingFast(dim=head_dim // 2,
    pt_seq_len=pt_grid, ft_seq_len=grid)``: (grid^2, head_dim) fp32 cos and
    sin.  f = theta^(-arange(0, dim, 2) / dim); positions t = arange(grid) /
    grid * pt_grid (the pretraining grid stretched over this one); each
    angle repeated twice, interleaved; cell (r, c) takes concat(F[r], F[c]),
    so a head's first half turns with the row and its second with the
    column; flattened row-major."""
    dim = head_dim // 2
    freqs = 1.0 / (ROPE_THETA ** (torch.arange(0, dim, 2)[:dim // 2].float() / dim))
    t = torch.arange(grid) / grid * pt_grid
    f = torch.einsum("i,j->ij", t, freqs).repeat_interleave(2, dim=-1)  # (grid, dim)
    table = torch.cat([f[:, None, :].expand(grid, grid, dim),
                       f[None, :, :].expand(grid, grid, dim)], dim=-1)
    return table.cos().reshape(-1, head_dim), table.sin().reshape(-1, head_dim)


def apply_eva(params: Dict, images: torch.Tensor, cfg, int8: Optional[bool] = None
              ) -> torch.Tensor:
    """Encode preprocessed images (B, H, W, 3) -> embeddings (B, embed_dim)
    through the tower of ``cfg.vision_block``.  K3, the W8A8 block, has no
    EVA-CLIP block: ``int8`` (None reads ``$PROTOCLIP_INT8``) raises."""
    if int8 or (int8 is None and int8_enabled()):
        raise ValueError(f"{cfg.name}: the W8A8 serving block (K3, $PROTOCLIP_INT8) has no "
                         f"EVA-CLIP block ({cfg.vision_block}); encode EVA02-CLIP backbones "
                         "in bf16")
    dtype = params["patch_embed"].dtype
    x = patchify(images.to(dtype), cfg.vision_patch_size) @ params["patch_embed"]
    x = x + params["patch_bias"].to(dtype)
    cls = params["class_embedding"].to(dtype).expand(x.shape[0], 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + params["positional_embedding"].to(dtype)
    if cfg.vision_block == POSTNORM:
        x = eva_postnorm_transformer(x, params["blocks"], cfg.vision_heads)
    else:
        x = eva_transformer(x, params["blocks"], cfg.vision_heads, params["rope"])
    cls_out = layer_norm(x[:, 0, :], params["ln_post"]["scale"], params["ln_post"]["bias"],
                         EVA_LN_EPS)
    return cls_out @ params["head"]["w"].to(dtype) + params["head"]["b"].to(dtype)


# -- EVA-CLIP's state-dict layout ---------------------------------------------------------


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))


def _ln(sd: Dict[str, np.ndarray], key: str) -> Dict[str, torch.Tensor]:
    return {"scale": _t(sd[f"{key}.weight"]), "bias": _t(sd[f"{key}.bias"])}


def _block(sd: Dict[str, np.ndarray], p: str) -> Params:
    a, m = f"{p}.attn", f"{p}.mlp"
    width = sd[f"{a}.q_proj.weight"].shape[1]
    zeros = np.zeros(width, np.float32)
    h = sd[f"{m}.w1.weight"].shape[0]
    hp = padded_hidden(h)
    w12 = np.zeros((width, 2 * hp), np.float32)
    w12[:, 0:2 * h:2], w12[:, 1:2 * h:2] = sd[f"{m}.w1.weight"].T, sd[f"{m}.w2.weight"].T
    b12 = np.zeros(2 * hp, np.float32)
    b12[0:2 * h:2], b12[1:2 * h:2] = sd[f"{m}.w1.bias"], sd[f"{m}.w2.bias"]
    w3 = np.zeros((hp, width), np.float32)
    w3[:h] = sd[f"{m}.w3.weight"].T
    return {
        "ln_1": _ln(sd, f"{p}.norm1"),
        "attn": {
            "wqkv": _t(np.concatenate([sd[f"{a}.{n}_proj.weight"].T for n in "qkv"], axis=1)),
            "bqkv": _t(np.concatenate([sd.get(f"{a}.q_bias", zeros), zeros,
                                       sd.get(f"{a}.v_bias", zeros)])),
            "ln_inner": _ln(sd, f"{a}.inner_attn_ln"),
            "wo": _t(sd[f"{a}.proj.weight"].T),
            "bo": _t(sd[f"{a}.proj.bias"]),
        },
        "ln_2": _ln(sd, f"{p}.norm2"),
        "mlp": {"w12": _t(w12), "b12": _t(b12), "ln_ffn": _ln(sd, f"{m}.ffn_ln"),
                "w3": _t(w3), "b3": _t(sd[f"{m}.w3.bias"])},
    }


def visual_from_state_dict(sd: Dict[str, np.ndarray], cfg) -> Params:
    """EVA-CLIP's ``visual.*`` keys (fp32 numpy) -> the port's tower of
    ``cfg.vision_block`` (fp32 CPU tensors; the post-norm tower through
    :func:`postnorm_visual_from_state_dict`).  A checkpoint's RoPE buffers
    (``*rope.freqs_cos``, ``*rope.freqs_sin``, wherever the model registered
    them) must equal the tables computed here within :data:`TABLE_ATOL`, or
    it raises."""
    if cfg.vision_block == POSTNORM:
        return postnorm_visual_from_state_dict(sd, cfg)
    patch, width = cfg.vision_patch_size, cfg.vision_width
    grid = cfg.image_resolution // patch
    cos, sin = rope_tables(grid, cfg.rope_pt_grid, width // cfg.vision_heads)
    for key, value in sd.items():
        if key.startswith("visual.") and key.endswith(("rope.freqs_cos", "rope.freqs_sin")):
            want = (cos if key.endswith("cos") else sin).numpy()
            if value.shape != want.shape or not np.allclose(value, want, rtol=0, atol=TABLE_ATOL):
                raise ValueError(f"{key} differs from the RoPE table of a {grid} x {grid} grid "
                                 f"pretrained at {cfg.rope_pt_grid} x {cfg.rope_pt_grid}")
    # OIHW (width, 3, P, P) -> (P*P*3, width): the (py, px, c) order of patchify
    pe = sd["visual.patch_embed.proj.weight"].transpose(2, 3, 1, 0).reshape(patch * patch * 3, -1)
    return {
        "patch_embed": _t(pe),
        "patch_bias": _t(sd["visual.patch_embed.proj.bias"]),
        "class_embedding": _t(sd["visual.cls_token"].reshape(width)),
        "positional_embedding": _t(sd["visual.pos_embed"].reshape(-1, width)),
        "rope": {"cos": cos, "sin": sin},
        "blocks": [_block(sd, f"visual.blocks.{i}") for i in range(cfg.vision_layers)],
        "ln_post": _ln(sd, "visual.norm"),
        "head": {"w": _t(sd["visual.head.weight"].T), "b": _t(sd["visual.head.bias"])},
    }


def postnorm_visual_from_state_dict(sd, cfg, dtype: torch.dtype = torch.float32,
                                    device="cpu") -> Params:
    """EVA-CLIP's post-norm ``visual.*`` keys (tensors or numpy arrays, of
    any float dtype) -> the port's post-norm tower on ``device``: weights and
    biases in ``dtype``, LayerNorms in fp32, as ``models.clip.cast_params``
    keeps them.  Each tensor is cast and moved before it is transposed or
    joined, one at a time, so the largest fp32 temporary is one
    LayerNorm's."""
    patch, width = cfg.vision_patch_size, cfg.vision_width

    def get(key, keep_fp32=False):
        return torch.as_tensor(sd[key]).to(device=device,
                                           dtype=torch.float32 if keep_fp32 else dtype)

    def ln(key):
        return {"scale": get(f"{key}.weight", True), "bias": get(f"{key}.bias", True)}

    def block(p):
        a, m = f"{p}.attn", f"{p}.mlp"
        wqkv = get(f"{a}.qkv.weight")
        zeros = torch.zeros(wqkv.shape[1], dtype=dtype, device=device)
        bq, bv = (get(f"{a}.{n}_bias") if f"{a}.{n}_bias" in sd else zeros for n in "qv")
        return {
            "ln_1": ln(f"{p}.norm1"),
            "attn": {"wqkv": wqkv.T.contiguous(), "bqkv": torch.cat([bq, zeros, bv]),
                     "wo": get(f"{a}.proj.weight").T.contiguous(), "bo": get(f"{a}.proj.bias")},
            "ln_2": ln(f"{p}.norm2"),
            "mlp": {"w_fc": get(f"{m}.fc1.weight").T.contiguous(), "b_fc": get(f"{m}.fc1.bias"),
                    "w_proj": get(f"{m}.fc2.weight").T.contiguous(),
                    "b_proj": get(f"{m}.fc2.bias")},
        }

    # OIHW (width, 3, P, P) -> (P*P*3, width): the (py, px, c) order of patchify
    pe = get("visual.patch_embed.proj.weight").permute(2, 3, 1, 0).reshape(patch * patch * 3, -1)
    return {
        "patch_embed": pe.contiguous(),
        "patch_bias": get("visual.patch_embed.proj.bias"),
        "class_embedding": get("visual.cls_token").reshape(width),
        "positional_embedding": get("visual.pos_embed").reshape(-1, width),
        "blocks": [block(f"visual.blocks.{i}") for i in range(cfg.vision_layers)],
        "ln_post": ln("visual.norm"),
        "head": {"w": get("visual.head.weight").T.contiguous(), "b": get("visual.head.bias")},
    }


def random_visual_state_dict(rng: np.random.Generator, cfg) -> Dict[str, np.ndarray]:
    """EVA-CLIP's ``visual.*`` keys of ``cfg.vision_block``'s layout drawn
    as its init draws them (weights, class and positional embeddings N(0,
    0.02^2), biases 0, LayerNorms the identity; the residual projections
    scaled by 1/sqrt(2 * layer)), as fp32 numpy arrays."""
    w, patch, h = cfg.vision_width, cfg.vision_patch_size, cfg.vision_mlp_width
    n_tokens = (cfg.image_resolution // patch) ** 2 + 1

    def normal(*shape, std=0.02):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    sd = {"visual.patch_embed.proj.weight": normal(w, 3, patch, patch),
          "visual.patch_embed.proj.bias": np.zeros(w, np.float32),
          "visual.cls_token": normal(1, 1, w), "visual.pos_embed": normal(1, n_tokens, w),
          "visual.head.weight": normal(cfg.embed_dim, w),
          "visual.head.bias": np.zeros(cfg.embed_dim, np.float32)}
    postnorm = cfg.vision_block == POSTNORM
    norms = ({"norm1": w, "norm2": w} if postnorm
             else {"norm1": w, "norm2": w, "attn.inner_attn_ln": w, "mlp.ffn_ln": h})
    mlp = ({"fc1": (h, w), "fc2": (w, h)} if postnorm
           else {"w1": (h, w), "w2": (h, w), "w3": (w, h)})
    for i in range(cfg.vision_layers):
        p = f"visual.blocks.{i}"
        rescale = np.float32((2.0 * (i + 1)) ** -0.5)
        if postnorm:
            sd[f"{p}.attn.qkv.weight"] = normal(3 * w, w)
        else:
            for n in "qkv":
                sd[f"{p}.attn.{n}_proj.weight"] = normal(w, w)
        sd[f"{p}.attn.q_bias"] = np.zeros(w, np.float32)
        sd[f"{p}.attn.v_bias"] = np.zeros(w, np.float32)
        sd[f"{p}.attn.proj.weight"] = normal(w, w) * rescale
        sd[f"{p}.attn.proj.bias"] = np.zeros(w, np.float32)
        for n, (rows, cols) in mlp.items():
            sd[f"{p}.mlp.{n}.weight"] = normal(rows, cols) * (rescale if n in ("w3", "fc2") else 1)
            sd[f"{p}.mlp.{n}.bias"] = np.zeros(rows, np.float32)
        for n, width in norms.items():
            sd[f"{p}.{n}.weight"] = np.ones(width, np.float32)
            sd[f"{p}.{n}.bias"] = np.zeros(width, np.float32)
    sd["visual.norm.weight"] = np.ones(w, np.float32)
    sd["visual.norm.bias"] = np.zeros(w, np.float32)
    return sd
