"""Operations and bytes of the image tower, and the card's peaks.

The counts follow ``chip_smoke.py::k2_work``: each input read once and
each output written once, activations in the compute type, LayerNorm
parameters in fp32, the MLP four times the width, the flops of the four
products and of the attention's two.  The peaks are NVIDIA's data sheet
for one H100 SXM (dense, at its 700 W limit).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
VALUE_BYTES = {"bfloat16": 2, "float32": 4}


def tokens(cfg: Dict) -> int:
    return (cfg["image_resolution"] // cfg["vision_patch_size"]) ** 2 + 1


def attention_flops(b: int, length: int, d: int) -> int:
    return 4 * b * length * length * d


def image_flops(cfg: Dict) -> int:
    """Model operations of one image through the image tower: the patch
    embedding, every block's four products and attention, the projection."""
    length, d, patch = tokens(cfg), cfg["vision_width"], cfg["vision_patch_size"]
    embed = 2 * (length - 1) * 3 * patch * patch * d
    block = 24 * length * d * d + attention_flops(1, length, d)
    return embed + cfg["vision_layers"] * block + 2 * d * cfg["embed_dim"]


def _gemm(m: int, k: int, n: int, vb: int, residual: bool = False) -> Tuple[int, int]:
    return (m * k + k * n + n + m * n * (2 if residual else 1)) * vb, 2 * m * k * n


def _layernorm(m: int, d: int, vb: int) -> Tuple[int, int]:
    return 2 * m * d * vb + 2 * d * 4, 8 * m * d


def encode_pieces(cfg: Dict, rows: int, dtype: str = "bfloat16") -> List[Tuple[str, int, int, int]]:
    """(piece, count, bytes, operations) of one encode of ``rows`` images:
    the patch embedding, the LayerNorms, each block's products and
    attention, and the projection."""
    vb = VALUE_BYTES[dtype]
    length, d, patch = tokens(cfg), cfg["vision_width"], cfg["vision_patch_size"]
    m, layers = rows * length, cfg["vision_layers"]
    return [
        ("patch_embed", 1, *_gemm(rows * (length - 1), 3 * patch * patch, d, vb)),
        ("ln_pre", 1, *_layernorm(m, d, vb)),
        ("ln_1", layers, *_layernorm(m, d, vb)),
        ("qkv", layers, *_gemm(m, d, 3 * d, vb)),
        ("attention", layers, 4 * m * d * vb, attention_flops(rows, length, d)),
        ("out_proj", layers, *_gemm(m, d, d, vb, residual=True)),
        ("ln_2", layers, *_layernorm(m, d, vb)),
        ("fc", layers, *_gemm(m, d, 4 * d, vb)),
        ("proj", layers, *_gemm(m, 4 * d, d, vb, residual=True)),
        ("ln_post", 1, *_layernorm(rows, d, vb)),
        ("projection", 1, *_gemm(rows, d, cfg["embed_dim"], vb)),
    ]


def bound_s(n_bytes: float, ops: float, dtype: str = "bfloat16") -> float:
    """The least time the card could take: bytes at the memory rate or
    operations at the peak, whichever is longer."""
    return max(n_bytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS[dtype])


def encode_bound_s(cfg: Dict, rows: int, dtype: str = "bfloat16") -> float:
    """Sum of every piece's bound for one encode of ``rows`` images."""
    return sum(count * bound_s(n_bytes, ops, dtype)
               for _, count, n_bytes, ops in encode_pieces(cfg, rows, dtype))
