"""The pieces of K2's fp32 path that run here on the CPU: the work and
bounds (``scripts/_card.py``) that ``chip_smoke.py`` and
``scripts/fp32_kernels.py`` time the fp32 kernels against, and the fp32
attention entry at every shape a backbone gives it, against the Pallas
kernel.  The fp32 kernels themselves run only on the card
(``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoclip_tpu.ops.pallas_kernels import fused_attention_packed as jax_fused_attention_packed
from protoclip_tpu_torch.ops import kernels
from protoclip_tpu_torch.scripts import _card, fp32_kernels
from tests.test_torch_cuda import backbone_attention_shapes

# ms at the data sheet's fp32 peaks (67 TFLOP/s, 3.35 TB/s): (shape, entry,
# least ms, what bounds it), worked by hand from the shapes
FP32_BOUNDS = [
    # ViT-B/16 image block, B=256, L=197, D=768 (m = 50432)
    ("image", "gemm_bias_epilogue.qkv", 2 * 50432 * 768 * 2304 / 67e9, "operations"),
    ("image", "gemm_bias_epilogue.out_proj", 2 * 50432 * 768 * 768 / 67e9, "operations"),
    ("image", "gemm_bias_epilogue.fc", 2 * 50432 * 768 * 3072 / 67e9, "operations"),
    ("image", "gemm_bias_epilogue.proj", 2 * 50432 * 3072 * 768 / 67e9, "operations"),
    ("image", "attention_packed", 4 * 256 * 197 * 197 * 768 / 67e9, "operations"),
    ("image", "layernorm_rows", (2 * 50432 * 768 * 4 + 2 * 768 * 4) / 3.35e9, "bytes"),
    # text block, B=1024, L=77, D=512, causal: the attention moves more
    # bytes than its flops take
    ("text", "attention_packed", 4 * 1024 * 77 * 512 * 4 / 3.35e9, "bytes"),
    ("text", "gemm_bias_epilogue.fc", 2 * 78848 * 512 * 2048 / 67e9, "operations"),
]
SHAPES = {"image": (256, 197, 768, False), "text": (1024, 77, 512, True)}


@pytest.mark.parametrize("shape,entry,want_ms,by", FP32_BOUNDS)
def test_fp32_bounds_of_the_k2_entries(shape, entry, want_ms, by):
    """``k2_work`` in fp32 counts 4 bytes a value (the LayerNorm's fp32
    parameters as in bf16) and ``bound_ms`` divides by the fp32 peak."""
    work = _card.k2_work(*SHAPES[shape], "float32")
    ms, bound_by, _, _ = _card.bound_ms(*work[entry], "float32")
    assert ms == pytest.approx(want_ms, rel=1e-12)
    assert bound_by == by


def test_fp32_work_is_the_bf16_work_in_4_byte_values():
    """Every entry's flops are the same in both modes, and its bytes those
    of 4-byte values where bf16 moves 2-byte ones (fp32 LayerNorm
    parameters aside)."""
    b, l, d, causal = SHAPES["image"]
    w16, w32 = _card.k2_work(b, l, d, causal), _card.k2_work(b, l, d, causal, "float32")
    assert w16.keys() == w32.keys()
    ln_params = {"layernorm_rows": 2 * d * 4, "fused_transformer_block": 4 * d * 4}
    for name, (n16, ops16) in w16.items():
        n32, ops32 = w32[name]
        assert ops32 == ops16
        fixed = ln_params.get(name, 0)
        assert n32 - fixed == 2 * (n16 - fixed), name
    # the four products of a block: 714 GFLOP, 10.66 ms at 67 TFLOP/s
    four = sum(w32[f"gemm_bias_epilogue.{g}"][1] for g in ("qkv", "out_proj", "fc", "proj"))
    assert four == 24 * b * l * d * d
    assert _card.bound_ms(0, four, "float32")[0] == pytest.approx(10.66, abs=5e-3)


@pytest.mark.parametrize("backbone,tower,L,dh", backbone_attention_shapes())
def test_fp32_attention_matches_pallas_at_every_backbone(backbone, tower, L, dh):
    """The fp32 attention entry at each backbone tower's length and head
    width (the text tower causal) against the Pallas kernel in interpret
    mode, at the fp32 bar of tests/test_pallas.py:12-36.  Its shared
    memory at these shapes is held on the card
    (``test_cuda_fp32_attention_smem_fits_every_backbone``)."""
    B, H, causal = 1, 2, tower == "text"
    rng = np.random.default_rng(L * dh)
    q, k, v = (rng.standard_normal((B, L, H * dh)).astype(np.float32) for _ in range(3))
    ref = np.asarray(jax_fused_attention_packed(*map(jnp.asarray, (q, k, v)), H, causal=causal,
                                                interpret=True))
    ours = kernels.fused_attention_packed(*map(torch.from_numpy, (q, k, v)), H, causal)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5)


# fp32_kernels' bounds at each of its shapes, worked by hand: (product or
# attention, least ms at the fp32 peaks, what bounds it)
FP32_SCRIPT_BOUNDS = {
    "image": [  # B=256, L=197, D=768: m = 50432
        ("qkv", 2 * 50432 * 768 * 2304 / 67e9, "operations"),
        ("out_proj", 2 * 50432 * 768 * 768 / 67e9, "operations"),
        ("fc", 2 * 50432 * 768 * 3072 / 67e9, "operations"),
        ("proj", 2 * 50432 * 3072 * 768 / 67e9, "operations"),
        ("attention", 4 * 256 * 197 * 197 * 768 / 67e9, "operations"),
    ],
    "text": [  # B=1024, L=77, D=512, causal: m = 78848
        ("qkv", 2 * 78848 * 512 * 1536 / 67e9, "operations"),
        ("out_proj", 2 * 78848 * 512 * 512 / 67e9, "operations"),
        ("fc", 2 * 78848 * 512 * 2048 / 67e9, "operations"),
        ("proj", 2 * 78848 * 2048 * 512 / 67e9, "operations"),
        ("attention", 4 * 1024 * 77 * 512 * 4 / 3.35e9, "bytes"),
    ],
    "vitl_image": [  # B=16, L=257, D=1024: m = 4112
        ("qkv", 2 * 4112 * 1024 * 3072 / 67e9, "operations"),
        ("out_proj", 2 * 4112 * 1024 * 1024 / 67e9, "operations"),
        ("fc", 2 * 4112 * 1024 * 4096 / 67e9, "operations"),
        ("proj", 2 * 4112 * 4096 * 1024 / 67e9, "operations"),
        ("attention", 4 * 16 * 257 * 257 * 1024 / 67e9, "operations"),
    ],
}


@pytest.mark.parametrize("shape", list(fp32_kernels.SHAPES))
def test_fp32_kernels_script_bounds_at_its_shapes(shape):
    """The bounds the side-by-side script prints beside each product and
    the attention (``fp32_kernels.bounds``, which ``gemm_rows`` and
    ``attention_row`` read) are the values worked by hand above."""
    got = fp32_kernels.bounds(shape)
    assert list(got) == [name for name, _, _ in FP32_SCRIPT_BOUNDS[shape]]
    for name, want_ms, by in FP32_SCRIPT_BOUNDS[shape]:
        ms, bound_by = got[name]
        assert ms == pytest.approx(want_ms, rel=1e-12), name
        assert bound_by == by, name


def test_fp32_kernels_script_needs_the_card(monkeypatch):
    """The side-by-side timing script runs on the card only: without CUDA
    it raises before building anything."""
    monkeypatch.setattr(fp32_kernels.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs an NVIDIA card"):
        fp32_kernels.main(["--runs", "1"])
