"""Operations and bytes of the EVA02 image tower, as ``work.py`` counts
OpenAI's: each input read once and each output written once, activations
in the compute type, LayerNorm parameters and RoPE tables in fp32, the
flops of the products and of the attention's two.

Per block (L tokens, width d, SwiGLU hidden H at its true width):
LN1; the QKV product and its RoPE epilogue (the fp32 tables read once, 3
flops a turned value of q and k over the L - 1 patch tokens); attention;
the inner sub-LN (width d); the out-projection with its residual; LN2; the
SwiGLU product (d -> 2H, written H wide; the epilogue's silu and product
counted at 5 flops a hidden value); the hidden's sub-LN over its true
width H; the down-projection with its residual.  So a block is 8 L d^2 +
6 L d H + 4 L^2 d model flops: 15.9 GFLOP at EVA02-L/14-336's L = 577, d =
1024, H = 2730, and an image 381.9 GFLOP with the patch embedding and head.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from benchmark.work import PEAK_FLOPS, VALUE_BYTES, _gemm, _layernorm, attention_flops, bound_s

ROPE_FLOPS = 3  # a turned value: two products and a sum
SWIGLU_FLOPS = 5  # a hidden value: silu's exp, add and divide, and the product


def tokens(cfg: Dict) -> int:
    return (cfg["image_resolution"] // cfg["vision_patch_size"]) ** 2 + 1


def image_flops(cfg: Dict) -> int:
    """Model operations of one image: the patch embedding, every block's
    products and attention, the head."""
    length, d, patch = tokens(cfg), cfg["vision_width"], cfg["vision_patch_size"]
    h = cfg["vision_mlp_width"]
    embed = 2 * (length - 1) * 3 * patch * patch * d
    block = 8 * length * d * d + 6 * length * d * h + attention_flops(1, length, d)
    return embed + cfg["vision_layers"] * block + 2 * d * cfg["embed_dim"]


def encode_pieces(cfg: Dict, rows: int, dtype: str = "bfloat16") -> List[Tuple[str, int, int, int]]:
    """(piece, count, bytes, operations) of one encode of ``rows`` images."""
    vb = VALUE_BYTES[dtype]
    length, d, patch = tokens(cfg), cfg["vision_width"], cfg["vision_patch_size"]
    h, layers = cfg["vision_mlp_width"], cfg["vision_layers"]
    m = rows * length
    dh = d // cfg["vision_heads"]
    qkv_bytes, qkv_ops = _gemm(m, d, 3 * d, vb)
    turned = rows * (length - 1) * 2 * d
    swiglu_bytes = (m * d + d * 2 * h + 2 * h + m * h) * vb
    return [
        ("patch_embed", 1, *_gemm(rows * (length - 1), 3 * patch * patch, d, vb)),
        ("ln_1", layers, *_layernorm(m, d, vb)),
        ("qkv_rope", layers, qkv_bytes + 2 * (length - 1) * dh * 4,
         qkv_ops + ROPE_FLOPS * turned),
        ("attention", layers, 4 * m * d * vb, attention_flops(rows, length, d)),
        ("ln_inner", layers, *_layernorm(m, d, vb)),
        ("out_proj", layers, *_gemm(m, d, d, vb, residual=True)),
        ("ln_2", layers, *_layernorm(m, d, vb)),
        ("swiglu", layers, swiglu_bytes, 2 * m * d * 2 * h + SWIGLU_FLOPS * m * h),
        ("ln_ffn", layers, *_layernorm(m, h, vb)),
        ("w3", layers, *_gemm(m, h, d, vb, residual=True)),
        ("ln_post", 1, *_layernorm(rows, d, vb)),
        ("head", 1, *_gemm(rows, d, cfg["embed_dim"], vb)),
    ]


def pieces_bound_s(cfg: Dict, rows: int, names, dtype: str = "bfloat16") -> float:
    """Sum of the bounds of the pieces ``names`` (all: None) for one encode
    of ``rows`` images."""
    return sum(count * bound_s(n_bytes, ops, dtype)
               for piece, count, n_bytes, ops in encode_pieces(cfg, rows, dtype)
               if names is None or piece in names)


def mfu(run):
    """Model operations of the valid images encoded over the window's wall
    time, against the peak of the compute type."""
    if "valid_images" not in run.counters:
        return None
    flops = run.counters["valid_images"] * image_flops(run.config)
    return 100.0 * flops / run.counters["window_s"] / PEAK_FLOPS[run.config["compute_dtype"]]


def kernel_s(run, name: str):
    """Device seconds of the window's kernels whose name holds ``name``
    (the trace's longest operations by name), or None where none does."""
    if run.trace is None:
        return None
    secs = [s for op, s in run.trace["device_ops"] if name in op]
    return sum(secs) if secs else None


def roofline(run, pieces, kernel: str):
    """Percent of the least time of ``pieces`` over every encode of the
    window against the device seconds of the kernel named ``kernel``."""
    secs = kernel_s(run, kernel)
    rows = run.counters.get("encode_rows")
    if not secs or not rows:
        return None
    dtype = run.config["compute_dtype"]
    return 100.0 * sum(pieces_bound_s(run.config, r, pieces, dtype) for r in rows) / secs
