"""Operations and bytes of EVA02-CLIP-bigE's post-norm image tower, as
``work.py`` counts OpenAI's: each input read once and each output written
once, activations in the compute type, LayerNorm parameters in fp32, the
flops of the products and of the attention's two.

Per block (L tokens, width d, MLP width H): the QKV product (no LayerNorm
before it); attention; the out-projection; the first post-LN residual,
x + LN1(a), which reads the branch a and the residual x and writes x; the
fc product with its exact-GELU epilogue (H wide); the proj product; the
second post-LN residual.  So a block is 8 L d^2 + 4 L d H + 4 L^2 d model
flops (a GELU MLP: 4 L d H, where EVA02's SwiGLU takes 6 L d H): 35.4 GFLOP
at bigE's L = 257, d = 1792, H = 15360, and an image 2.266 TFLOP with the
patch embedding and head.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from benchmark.work import PEAK_FLOPS, VALUE_BYTES, _gemm, _layernorm, attention_flops, bound_s
from benchmark.work_eva import kernel_s, tokens

POSTLN_FLOPS = 10  # a value: the LayerNorm's 8 and the residual sum, counted at 10
POSTLN_PIECES = ("postln_1", "postln_2")


def image_flops(cfg: Dict) -> int:
    """Model operations of one image: the patch embedding, every block's
    products and attention, the head."""
    length, d, patch = tokens(cfg), cfg["vision_width"], cfg["vision_patch_size"]
    h = cfg["vision_mlp_width"]
    embed = 2 * (length - 1) * 3 * patch * patch * d
    block = 8 * length * d * d + 4 * length * d * h + attention_flops(1, length, d)
    return embed + cfg["vision_layers"] * block + 2 * d * cfg["embed_dim"]


def _postln(m: int, d: int, vb: int) -> Tuple[int, int]:
    """x + LN(a): a and x read, the sum written, the LayerNorm's fp32
    parameters read."""
    return 3 * m * d * vb + 2 * d * 4, POSTLN_FLOPS * m * d


def encode_pieces(cfg: Dict, rows: int, dtype: str = "bfloat16") -> List[Tuple[str, int, int, int]]:
    """(piece, count, bytes, operations) of one encode of ``rows`` images."""
    vb = VALUE_BYTES[dtype]
    length, d, patch = tokens(cfg), cfg["vision_width"], cfg["vision_patch_size"]
    h, layers = cfg["vision_mlp_width"], cfg["vision_layers"]
    m = rows * length
    return [
        ("patch_embed", 1, *_gemm(rows * (length - 1), 3 * patch * patch, d, vb)),
        ("qkv", layers, *_gemm(m, d, 3 * d, vb)),
        ("attention", layers, 4 * m * d * vb, attention_flops(rows, length, d)),
        ("out_proj", layers, *_gemm(m, d, d, vb)),
        ("postln_1", layers, *_postln(m, d, vb)),
        ("fc", layers, *_gemm(m, d, h, vb)),
        ("proj", layers, *_gemm(m, h, d, vb)),
        ("postln_2", layers, *_postln(m, d, vb)),
        ("ln_post", 1, *_layernorm(rows, d, vb)),
        ("head", 1, *_gemm(rows, d, cfg["embed_dim"], vb)),
    ]


def pieces_bound_s(cfg: Dict, rows: int, names, dtype: str = "bfloat16") -> float:
    """Sum of the bounds of the pieces ``names`` (all: None) for one encode
    of ``rows`` images."""
    return sum(count * bound_s(n_bytes, ops, dtype)
               for piece, count, n_bytes, ops in encode_pieces(cfg, rows, dtype)
               if names is None or piece in names)


def encode_bound_s(run):
    """Every piece's bound over the encodes of the window, or None."""
    rows = run.counters.get("encode_rows")
    if not rows:
        return None
    return sum(pieces_bound_s(run.config, r, None, run.config["compute_dtype"]) for r in rows)


def mfu(run):
    """Model operations of the valid images encoded over the window's wall
    time, against the peak of the compute type."""
    if "valid_images" not in run.counters:
        return None
    flops = run.counters["valid_images"] * image_flops(run.config)
    return 100.0 * flops / run.counters["window_s"] / PEAK_FLOPS[run.config["compute_dtype"]]


def roofline(run, pieces, kernel: str):
    """Percent of the least time of ``pieces`` over every encode of the
    window against the device seconds of the kernel named ``kernel``; None
    where the trace holds no such kernel."""
    secs = kernel_s(run, kernel)
    rows = run.counters.get("encode_rows")
    if not secs or not rows:
        return None
    dtype = run.config["compute_dtype"]
    return 100.0 * sum(pieces_bound_s(run.config, r, pieces, dtype) for r in rows) / secs
