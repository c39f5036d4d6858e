"""The op and byte counts against hand-worked values."""

import json

import pytest

from benchmark import work
from benchmark.harness import Bench


def _config(name):
    return Bench().config(name)


def test_image_flops_by_hand():
    # ViT-B/16: L = 197, d = 768, 12 blocks of 24 L d^2 + 4 L^2 d, the
    # 196-patch embedding of 768 inputs and the 768 -> 512 projection
    b16 = 2 * 196 * 768 * 768 + 12 * (24 * 197 * 768 ** 2 + 4 * 197 ** 2 * 768) + 2 * 768 * 512
    assert work.image_flops(_config("vit-b16")) == b16
    assert b16 / 1e9 == pytest.approx(35.1, abs=0.05)
    # ViT-L/14: L = 257, d = 1024, 24 blocks, 256 patches of 588, 1024 -> 768
    l14 = (2 * 256 * 588 * 1024 + 24 * (24 * 257 * 1024 ** 2 + 4 * 257 ** 2 * 1024)
           + 2 * 1024 * 768)
    assert work.image_flops(_config("vit-l14")) == l14
    assert l14 / 1e9 == pytest.approx(162.0, abs=0.05)


@pytest.mark.parametrize("name", ["vit-b16", "vit-l14"])
def test_pieces_sum_to_the_image_flops(name):
    cfg = _config(name)
    pieces = work.encode_pieces(cfg, 1024)
    products = sum(count * ops for piece, count, _, ops in pieces if not piece.startswith("ln"))
    assert products == 1024 * work.image_flops(cfg)


def test_bounds_by_hand():
    cfg = _config("vit-b16")
    pieces = {p: (count, b, ops) for p, count, b, ops in work.encode_pieces(cfg, 1024)}
    m = 1024 * 197
    # qkv: read x (m x 768) and W (768 x 2304) and the bias, write m x 2304, bf16
    assert pieces["qkv"] == (12, (m * 768 + 768 * 2304 + 2304 + m * 2304) * 2, 2 * m * 768 * 2304)
    # the out projection also reads the residual
    assert pieces["out_proj"][1] == (m * 768 + 768 * 768 + 768 + 2 * m * 768) * 2
    # a LayerNorm reads and writes m x 768 once, its two fp32 vectors once
    assert pieces["ln_1"][1] == 2 * m * 768 * 2 + 2 * 768 * 4
    ops = 2 * m * 768 * 2304
    assert work.bound_s(pieces["qkv"][1], ops) == pytest.approx(ops / 989e12)
    ln_bytes = pieces["ln_1"][1]
    assert work.bound_s(ln_bytes, 8 * m * 768) == pytest.approx(ln_bytes / 3.35e12)


def test_peaks_are_the_data_sheets():
    assert work.PEAK_FLOPS["bfloat16"] == 989e12
    assert work.PEAK_BYTES_PER_S == 3.35e12
    assert json.loads(json.dumps(work.PEAK_FLOPS)) == work.PEAK_FLOPS
