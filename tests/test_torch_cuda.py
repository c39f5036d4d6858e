"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where CUDA is not available.
The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch; there, skip the JAX-pinning conftest:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from protoclip_tpu_torch.models.layers import init_block_params
from protoclip_tpu_torch.ops import kernels

BARS = {torch.bfloat16: 1e-2, torch.float32: 1e-5}  # max|diff| / max|plain|
MIN_COSINE = 0.9999


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.device("cuda")


def _block(d, dtype, device, seed=0):
    """One layer with CLIP's init and non-trivial LN affine and biases."""
    rng = np.random.default_rng(seed)
    blk = init_block_params(rng, 1, d)[0]
    for grp in ("ln_1", "ln_2"):
        blk[grp]["scale"] = torch.from_numpy(1 + 0.1 * rng.standard_normal(d, dtype=np.float32))
        blk[grp]["bias"] = torch.from_numpy(0.1 * rng.standard_normal(d, dtype=np.float32))
    for grp, key in (("attn", "bqkv"), ("attn", "bo"), ("mlp", "b_fc"), ("mlp", "b_proj")):
        n = blk[grp][key].shape[0]
        blk[grp][key] = torch.from_numpy(0.02 * rng.standard_normal(n, dtype=np.float32))
    return {
        grp: {k: v.to(device=device, dtype=torch.float32 if grp.startswith("ln") else dtype)
              for k, v in sub.items()}
        for grp, sub in blk.items()
    }


def _assert_close(out, ref, dtype):
    torch.cuda.synchronize()
    out, ref = out.double().flatten(), ref.double().flatten()
    assert float((out - ref).abs().max()) / float(ref.abs().max()) < BARS[dtype]
    assert float(out @ ref / (out.norm() * ref.norm())) > MIN_COSINE


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("L,D,H,causal", [(197, 768, 12, False), (77, 512, 8, True),
                                          (50, 128, 2, False), (13, 64, 1, True)])
def test_cuda_kernels_match_plain(cuda_device, dtype, L, D, H, causal):
    blk = _block(D, dtype, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(3, L, D, device=cuda_device, generator=g).to(dtype)
    kernels.reset_launch_counts()
    _assert_close(kernels.fused_transformer_block(x, blk, H, causal),
                  kernels.fused_transformer_block_plain(x, blk, H, causal), dtype)
    _assert_close(kernels.fused_attention_packed(x, x, x, H, causal),
                  kernels.fused_attention_packed_plain(x, x, x, H, causal), dtype)
    xp = torch.nn.functional.pad(x, (0, 0, 0, 3))
    _assert_close(kernels.fused_transformer_block(xp, blk, H, causal, length=L),
                  kernels.fused_transformer_block_plain(xp, blk, H, causal, length=L), dtype)
    assert kernels.launch_counts() == {
        "layernorm_rows": 4, "gemm_bias_epilogue": 8, "attention_packed": 3,
        "fused_transformer_block": 2, "fused_attention_packed": 1,
    }


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    x = torch.zeros(2, 5, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError, match="not supported"):
        kernels.layernorm_rows(x, torch.ones(64, device=cuda_device), torch.zeros(64, device=cuda_device))
    x = torch.zeros(2, 5, 64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.layernorm_rows(x.transpose(0, 1), torch.ones(64, device=cuda_device),
                               torch.zeros(64, device=cuda_device))
    with pytest.raises(ValueError, match="on the card"):
        kernels.gemm_bias_epilogue(x, torch.zeros(64, 8), torch.zeros(8), "bias")
    with pytest.raises(ValueError, match="head dim"):
        kernels.attention_packed(*(torch.zeros(1, 4, 256, device=cuda_device),) * 3, 1)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.attention_packed(*(torch.zeros(1, 600, 128, device=cuda_device),) * 3, 1)
