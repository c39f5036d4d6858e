"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where CUDA is not available.
The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch; there, skip the JAX-pinning conftest:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from chip_smoke import synthetic_tokenize
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
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    assert launched == {
        "layernorm_rows": 4, "gemm_bias_epilogue": 8, "attention_packed": 3,
        "fused_transformer_block": 2, "fused_attention_packed": 1,
    }


# K3's bars against its plain version: a quantization step is amax/127, and
# LayerNorm and attention sum in another order than the plain version, so an
# int8 code on a rounding tie may move one step (K2's fp32 bar does not apply)
INT8_BARS = {torch.bfloat16: (2e-2, 0.9999), torch.float32: (1e-2, 0.99999)}


def _assert_int8_block_close(out, ref, dtype):
    torch.cuda.synchronize()
    out, ref = out.double().flatten(), ref.double().flatten()
    rel_bar, cos_bar = INT8_BARS[dtype]
    assert float((out - ref).abs().max()) / float(ref.abs().max()) < rel_bar
    assert float(out @ ref / (out.norm() * ref.norm())) > cos_bar


def _assert_ln_quant_close(got, want, bf16_stats=False):
    """LayerNorm statistics sum in another order: codes equal in >= 99.9%,
    never more than one step apart, scales within 1e-6 relative.  With
    ``bf16_stats`` a sum on a rounding tie of the bf16 mean or variance
    moves its row's scale by up to a bf16 ulp: scales within 1e-6 in >=
    99.9% of rows and none more than 2^-7 apart."""
    (q, s), (rq, rs) = got, want
    step = (q.int() - rq.int()).abs()
    assert int(step.max()) <= 1 and float((step == 0).float().mean()) >= 0.999
    rel = (s - rs).abs() / rs
    if bf16_stats:
        assert float((rel <= 1e-6).float().mean()) >= 0.999 and float(rel.max()) <= 2.0 ** -7
    else:
        assert float(rel.max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("L,D,H,causal", [(197, 768, 12, False), (77, 512, 8, True),
                                          (50, 128, 2, False), (13, 64, 1, True)])
def test_cuda_int8_kernels_match_plain(cuda_device, dtype, L, D, H, causal):
    blk = _block(D, dtype, cuda_device)
    q = kernels.quantize_block(blk)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(3, L, D, device=cuda_device, generator=g).to(dtype)
    hid = torch.randn(3, L, 4 * D, device=cuda_device, generator=g)  # fp32, as fc leaves it
    kernels.reset_launch_counts()
    # quant_rows (mode b) and the three GEMM epilogues: bit-exact
    for t in (x, hid):
        for got, want in zip(kernels.quant_rows(t), kernels.quant_rows_plain(t)):
            assert torch.equal(got, want)
    _assert_ln_quant_close(kernels.layernorm_quant_rows(x, q["ln1s"], q["ln1b"]),
                           kernels.layernorm_quant_rows_plain(x, q["ln1s"], q["ln1b"]))
    a_q, a_s = kernels.layernorm_quant_rows_plain(x, q["ln1s"], q["ln1b"])
    h_q, h_s = kernels.quant_rows_plain(hid)
    for args, epi, res in (((a_q, a_s, q["wqkv"], q["sqkv"], q["bqkv"]), "dequant_bias", None),
                           ((a_q, a_s, q["wo"], q["so"], q["bo"]), "dequant_bias_residual", x),
                           ((a_q, a_s, q["wfc"], q["sfc"], q["bfc"]), "dequant_bias_gelu", None),
                           ((h_q, h_s, q["wproj"], q["sproj"], q["bproj"]),
                            "dequant_bias_residual", x)):
        got = kernels.gemm_int8_epilogue(*args, epi, dtype, residual=res)
        assert torch.equal(got, kernels.gemm_int8_epilogue_plain(*args, epi, dtype, residual=res))
    # K3, whole and pre-padded with length
    _assert_int8_block_close(kernels.fused_transformer_block_int8(x, q, H, causal),
                             kernels.fused_transformer_block_int8_plain(x, q, H, causal), dtype)
    xp = torch.nn.functional.pad(x, (0, 0, 0, 3))
    _assert_int8_block_close(
        kernels.fused_transformer_block_int8(xp, q, H, causal, length=L),
        kernels.fused_transformer_block_int8_plain(xp, q, H, causal, length=L), dtype)
    # K4 on head-major views
    qh, kh, vh = (torch.randn(3, H, L, D // H, device=cuda_device, generator=g).to(dtype)
                  for _ in range(3))
    _assert_close(kernels.fused_attention(qh, kh, vh, causal),
                  kernels.fused_attention_plain(qh, kh, vh, causal), dtype)
    counts = kernels.launch_counts()
    assert counts["fused_transformer_block_int8"] == 2 and counts["fused_attention"] == 1
    assert counts["gemm_int8_epilogue"] == 4 + 8 and counts["quant_rows"] == 2 + 4
    assert counts["layernorm_quant_rows"] == 1 + 4 and counts["attention_packed"] == 2
    assert counts["fused_transformer_block"] == 0 and counts["gemm_bias_epilogue"] == 0


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
    # bf16 keeps Q's tile and all of K and V in shared memory: at dh=128 it
    # takes L up to 352
    lib = kernels._build.load_library()
    assert lib.attention_packed_smem_bytes(1, 352, 128) <= kernels.SMEM_PER_BLOCK
    assert lib.attention_packed_smem_bytes(1, 353, 128) > kernels.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="shared memory"):
        kernels.attention_packed(
            *(torch.zeros(1, 353, 128, device=cuda_device, dtype=torch.bfloat16),) * 3, 1)
    # 16-byte pieces: K, N, dh and strides in multiples of 8, aligned bases
    def zb(*shape):
        return torch.zeros(*shape, device=cuda_device, dtype=torch.bfloat16)

    with pytest.raises(ValueError, match="K=68 is not a multiple of 8"):
        kernels.gemm_bias_epilogue(zb(4, 68), zb(68, 8), zb(8), "bias")
    with pytest.raises(ValueError, match="N=12 is not a multiple of 8"):
        kernels.gemm_bias_epilogue(zb(4, 64), zb(64, 12), zb(12), "bias")
    with pytest.raises(ValueError, match="16-byte boundary"):
        kernels.gemm_bias_epilogue(zb(4 * 64 + 1)[1:].view(4, 64), zb(64, 8), zb(8), "bias")
    qkv = torch.zeros(2, 5, 3 * 36, device=cuda_device, dtype=torch.bfloat16)  # dh = 36
    with pytest.raises(ValueError, match="dh=36 is not a multiple of 8"):
        kernels.attention_packed(qkv[..., :36], qkv[..., 36:72], qkv[..., 72:], 1)
    qkv = torch.zeros(2, 8, 3 * 64 + 4, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="row stride=196"):
        kernels.attention_packed(qkv[..., :64], qkv[..., 64:128], qkv[..., 128:192], 1)
    qkv = torch.zeros(2, 5, 3 * 64 + 1, device=cuda_device, dtype=torch.bfloat16)[..., 1:]
    with pytest.raises(ValueError, match="stride|boundary"):
        kernels.attention_packed(qkv[..., :64], qkv[..., 64:128], qkv[..., 128:192], 1)
    a_q = torch.zeros(4, 64, dtype=torch.int8, device=cuda_device)
    a_s = torch.ones(4, 1, device=cuda_device)
    w_q = torch.zeros(8, 64, dtype=torch.int8, device=cuda_device)
    w_s, b = torch.ones(8, device=cuda_device), torch.zeros(8, device=cuda_device)
    with pytest.raises(TypeError, match="int8"):
        kernels.gemm_int8_epilogue(a_q.float(), a_s, w_q, w_s, b, "dequant_bias", torch.float32)
    with pytest.raises(ValueError, match="do not chain"):
        kernels.gemm_int8_epilogue(a_q, a_s, w_q.t().contiguous(), w_s, b, "dequant_bias",
                                   torch.float32)
    # the int8 GEMM's TMA rows: K in multiples of 16, N of 8, aligned bases
    with pytest.raises(ValueError, match="K=72 is not a multiple of 16"):
        kernels.gemm_int8_epilogue(a_q.new_zeros(4, 72), a_s, w_q.new_zeros(8, 72), w_s, b,
                                   "dequant_bias", torch.float32)
    with pytest.raises(ValueError, match="N=12 is not a multiple of 8"):
        kernels.gemm_int8_epilogue(a_q, a_s, w_q.new_zeros(12, 64), w_s.new_ones(12),
                                   b.new_zeros(12), "dequant_bias", torch.float32)
    with pytest.raises(ValueError, match="16-byte boundary"):
        kernels.gemm_int8_epilogue(a_q.new_zeros(4 * 64 + 1)[1:].view(4, 64), a_s, w_q, w_s, b,
                                   "dequant_bias", torch.float32)
    # quant_rows holds a row in registers: W a multiple of 8 up to 4096
    with pytest.raises(ValueError, match="W=100 is not a multiple of 8"):
        kernels.quant_rows(torch.zeros(4, 100, device=cuda_device))
    with pytest.raises(ValueError, match="row width 4104"):
        kernels.quant_rows(torch.zeros(4, 4104, device=cuda_device))
    with pytest.raises(ValueError, match="differ"):
        kernels.fused_attention(*(torch.zeros(1, 2, 8, 64, device=cuda_device),) * 2,
                                torch.zeros(1, 2, 9, 64, device=cuda_device))


def _ulp_steps(out, ref):
    """|out - ref| in ulps of their dtype, counted across zero."""
    int_t, width = (torch.int16, 16) if out.dtype == torch.bfloat16 else (torch.int32, 32)

    def ordered(t):
        bits = t.contiguous().view(int_t).long()
        return torch.where(bits >= 0, bits, -(bits + (1 << (width - 1))))

    return (ordered(out) - ordered(ref)).abs()


def _assert_within_an_ulp(out, ref):
    """QuickGELU op by op: expf on the card and PyTorch's exp may differ by
    an fp32 ulp before rounding: >= 99.9% equal, none more than one ulp."""
    torch.cuda.synchronize()
    steps = _ulp_steps(out, ref)
    assert int(steps.max()) <= 1 and float((steps == 0).float().mean()) >= 0.999


def _assert_int8_attention_close(got, want, v):
    """``attention_int8`` against its plain version: bit-exact, or, where
    the softmax sums in another order move a weight code a step on a
    rounding tie, no output more than two steps of v_amax / 127 off and a
    cosine above MIN_COSINE."""
    torch.cuda.synchronize()
    if torch.equal(got, want):
        return
    step = float(v.abs().max()) / 127
    got, want = got.double().flatten(), want.double().flatten()
    assert float((got - want).abs().max()) <= 2 * step
    assert float(got @ want / (got.norm() * want.norm())) > MIN_COSINE


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("L,D,H,length", [(200, 768, 12, 197), (264, 1024, 16, 257),
                                          (16, 64, 2, 13)])
def test_cuda_bench_modes_and_kernels_match_plain(cuda_device, dtype, L, D, H, length):
    """The block-variant bench's modes and its two kernels against their
    plain versions: quantizers and int8 epilogues bit-exact, the int8
    epilogue's QuickGELU in bf16 within an ulp, the bf16 GEMM and attention
    at the card's bars."""
    blk = _block(D, dtype, cuda_device)
    q = kernels.quantize_block(blk)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(4, L, D, device=cuda_device, generator=g).to(dtype)
    qkv = torch.randn(4, L, 3 * D, device=cuda_device, generator=g).to(dtype)
    hid = torch.randn(4, L, 4 * D, device=cuda_device, generator=g).to(dtype)
    sl = (qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:])
    kernels.reset_launch_counts()
    for mode in ("q_round", "no_softmax"):
        _assert_close(kernels.attention_packed(*sl, H, False, length, mode),
                      kernels.fused_attention_packed_plain(*sl, H, False, length, mode), dtype)
    for group in (1, 2, 4):
        _assert_int8_attention_close(kernels.attention_int8(*sl, H, length, group),
                                     kernels.attention_int8_plain(*sl, H, length, group), sl[2])
    assert torch.equal(kernels.qkv_sum(qkv), kernels.qkv_sum_plain(qkv))
    for mode in ("recip", "static", "cast"):
        for t in (x, hid.float()):
            for got, want in zip(kernels.quant_rows(t, mode), kernels.quant_rows_plain(t, mode)):
                assert torch.equal(got, want)
        _assert_ln_quant_close(kernels.layernorm_quant_rows(x, q["ln1s"], q["ln1b"], mode=mode),
                               kernels.layernorm_quant_rows_plain(x, q["ln1s"], q["ln1b"],
                                                                  mode=mode))
    _assert_ln_quant_close(
        kernels.layernorm_quant_rows(x, q["ln1s"], q["ln1b"], bf16_stats=True),
        kernels.layernorm_quant_rows_plain(x, q["ln1s"], q["ln1b"], bf16_stats=True))
    # the bf16 GEMM sums in another order, so T(acc + b) may differ by an
    # ulp before QuickGELU: the GEMM's bars; the int8 epilogue below has an
    # exact accumulator and meets the ulp rule
    fc = (x, blk["mlp"]["w_fc"], blk["mlp"]["b_fc"], "bias_gelu_bf16")
    _assert_close(kernels.gemm_bias_epilogue(*fc), kernels.gemm_bias_epilogue_plain(*fc), dtype)
    w_down = (q["wproj"].t().to(dtype) * q["sproj"].to(dtype)).contiguous()
    _assert_close(kernels.gemm_bias_epilogue(hid, w_down, q["bproj"], "bias32_residual", x),
                  kernels.gemm_bias_epilogue_plain(hid, w_down, q["bproj"], "bias32_residual", x),
                  dtype)
    a_q = kernels.layernorm_quant_rows_plain(x, q["ln2s"], q["ln2b"])
    for epi in ("dequant_bias_gelu_bf16", "dequant_bias_f32", "dequant_bias_gelu_round"):
        args = (*a_q, q["wfc"], q["sfc"], q["bfc"], epi, dtype)
        got, want = kernels.gemm_int8_epilogue(*args), kernels.gemm_int8_epilogue_plain(*args)
        if epi == "dequant_bias_gelu_bf16":
            _assert_within_an_ulp(got, want)
        else:
            assert torch.equal(got, want)
    counts = kernels.launch_counts()
    assert counts["attention_packed.q_round"] == counts["attention_packed.no_softmax"] == 1
    assert counts["attention_int8"] == 3 and counts["qkv_sum"] == 1
    assert counts["quant_rows.recip"] == counts["quant_rows.static"] == 2
    assert counts["layernorm_quant_rows.recip"] == counts["layernorm_quant_rows.cast"] == 1
    assert counts["layernorm_quant_rows.bf16_stats"] == 1
    assert counts["gemm_int8_epilogue.dequant_bias_f32"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["v0", "v1", "v2", "v10", "int8", "int8h", "int8gb",
                                  "int8noattn", "int8static", "int8recip", "int8cast",
                                  "int8lnb", "int8s", "micro:mlp_pallas", "micro:int8mlp",
                                  "micro:int8mlp_nogelu", "micro:int8qkv", "micro:attn_pallas",
                                  "micro:attn_nosm", "micro:attn_noqkv"])
def test_cuda_bench_stacks_match_plain(cuda_device, name):
    """Each family's 12-layer stack of the bench through the kernels against
    the plain versions on the card, at a reduced batch of the ViT-B/16
    bench geometry (B=16, LP=200): bf16 rel < 2e-2 and cosine > 0.9999,
    int8 rel < 5e-2 and cosine > 0.999."""
    from protoclip_tpu_torch.ops import block_variants as bv
    from protoclip_tpu_torch.scripts import bench_block_variants as bench

    geom = bv.Geometry(batch=16)
    prep = next(bench.iter_prepared([name], geom, cuda_device))
    out = bench.stack_output(prep, bv.KERNEL_OPS)
    ref = bench.stack_output(prep, bv.PLAIN_OPS)
    torch.cuda.synchronize()
    out, ref = out.double().flatten(), ref.double().flatten()
    rel_bar, cos_bar = (5e-2, 0.999) if "int8" in name else (2e-2, 0.9999)
    assert float((out - ref).abs().max()) / float(ref.abs().max()) < rel_bar
    assert float(out @ ref / (out.norm() * ref.norm())) > cos_bar


def _packed_and_heads(qkv, h):
    """The three layouts of one set of q, k, v: column slices of a fused
    (B, L, 3D) buffer, three packed (B, L, D) tensors, and head-major
    (B, H, L, dh) tensors."""
    d = qkv.shape[-1] // 3
    sl = (qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:])
    packed = tuple(t.contiguous() for t in sl)
    b, l, _ = qkv.shape
    heads = tuple(t.reshape(b, l, h, d // h).transpose(1, 2).contiguous() for t in sl)
    return sl, packed, heads


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("L,causal", [(1, False), (16, False), (17, False), (77, True),
                                      (197, False), (257, False)])
def test_cuda_attention_edges_match_plain(cuda_device, L, causal, dh):
    """The tensor-core attention's edges: a single row, one and a bit of a
    16-key tile, the text block's causal L, the image lengths, dh padded to
    32/64/128, a length below L, both bench modes, and all three stride
    layouts (QKV slices, packed K1, head-major K4)."""
    H = 2
    g = torch.Generator(device=cuda_device).manual_seed(L * 1000 + dh)
    for dtype in (torch.bfloat16, torch.float32):
        if dtype == torch.float32 and L == 257 and dh == 128:
            continue  # beyond the exact fp32 kernel's shared memory
        qkv = torch.randn(3, L, 3 * H * dh, device=cuda_device, generator=g).to(dtype)
        sl, packed, heads = _packed_and_heads(qkv, H)
        for length in sorted({L, max(1, L - 5)}):
            for mode in ("softmax", "q_round", "no_softmax"):
                _assert_close(kernels.attention_packed(*sl, H, causal, length, mode),
                              kernels.fused_attention_packed_plain(*sl, H, causal, length, mode),
                              dtype)
        _assert_close(kernels.fused_attention_packed(*packed, H, causal),
                      kernels.fused_attention_packed_plain(*packed, H, causal), dtype)
        _assert_close(kernels.fused_attention(*heads, causal),
                      kernels.fused_attention_plain(*heads, causal), dtype)


# the int8 attention core's edges: one row, a 16-row warp tile and one past
# it, the text length, the bench's padded image rows and ViT-L/14's 257 and
# 264; every head width class of the 32-byte k-step (8 ... 128)
INT8_ATTENTION_L = (1, 15, 16, 17, 77, 200, 257, 264)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [8, 24, 32, 64, 128])
@pytest.mark.parametrize("L", INT8_ATTENTION_L)
def test_cuda_int8_attention_edges_match_plain(cuda_device, L, dh):
    """The s8 tensor-core attention core where L is no multiple of its 16-row
    and 32-key tiles, length = L and below it, dh zero-padded to a 32-byte
    k-step, one v scale per 1, 2 and 4 batch elements, bf16 and fp32 on
    the same int8 path."""
    H = 2
    g = torch.Generator(device=cuda_device).manual_seed(L * 1000 + dh)
    kernels.reset_launch_counts()
    calls = 0
    for dtype in (torch.bfloat16, torch.float32):
        qkv = (torch.randn(4, L, 3 * H * dh, device=cuda_device, generator=g) * 2).to(dtype)
        sl = (qkv[..., :H * dh], qkv[..., H * dh:2 * H * dh], qkv[..., 2 * H * dh:])
        for length in sorted({L, max(1, L - 5)}):
            for group in (1, 2, 4):
                _assert_int8_attention_close(kernels.attention_int8(*sl, H, length, group),
                                             kernels.attention_int8_plain(*sl, H, length, group),
                                             sl[2])
                calls += 1
    assert kernels.launch_counts()["attention_int8"] == calls
    with pytest.raises(ValueError, match="dh=12 is not a multiple of 8"):
        qkv = torch.zeros(4, L, 3 * 12, device=cuda_device)
        kernels.attention_int8(qkv[..., :12], qkv[..., 12:24], qkv[..., 24:], 1)
    with pytest.raises(ValueError, match="16-byte boundary"):
        qkv = torch.zeros(4 * L * 3 * dh + 1, device=cuda_device)[1:].view(4, L, 3 * dh)
        kernels.attention_int8(qkv[..., :dh], qkv[..., dh:2 * dh], qkv[..., 2 * dh:], 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("epilogue", ["bias", "bias_residual", "bias_gelu", "bias_gelu_bf16",
                                      "bias32_residual"])
def test_cuda_gemm_ragged_edges_match_plain(cuda_device, dtype, epilogue):
    """The GEMM where no dimension is a multiple of its tile: M = 8 x 197
    rows (not a multiple of 128), N = 192 (D = 64: half a 128-column tile),
    K = 200 (not a multiple of the 64-deep K step); each epilogue at the
    card's bars (the accumulator sums in another order)."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    m, k, n = 8 * 197, 200, 192
    a = torch.randn(8, 197, k, device=cuda_device, generator=g).to(dtype)
    w = (torch.randn(k, n, device=cuda_device, generator=g) * k ** -0.5).to(dtype)
    bias = (torch.randn(n, device=cuda_device, generator=g) * 0.1).to(
        torch.float32 if epilogue == "bias32_residual" else dtype)
    res = (torch.randn(8, 197, n, device=cuda_device, generator=g).to(dtype)
           if epilogue in ("bias_residual", "bias32_residual") else None)
    out = kernels.gemm_bias_epilogue(a, w, bias, epilogue, res)
    assert out.shape == (8, 197, n) and a.numel() // k == m
    _assert_close(out, kernels.gemm_bias_epilogue_plain(a, w, bias, epilogue, res), dtype)


# the int8 GEMM's edges: one row and a ragged 8 x 197; K from one 16-byte
# TMA row to 4096 (208: a ragged 128-byte K step); N one 8-column piece,
# half a tile and the ViT-B/16 QKV width
INT8_EDGE_M = (1, 8 * 197)
INT8_EDGE_K = (16, 208, 640, 3072, 4096)
INT8_EDGE_N = (8, 192, 2304)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("epilogue", list(kernels._INT8_EPILOGUES))
def test_cuda_int8_gemm_edges_match_plain(cuda_device, dtype, epilogue):
    """The s8 wgmma GEMM where M, K and N are not multiples of its tile,
    each epilogue, bit-exact against its plain version (the int32
    accumulator is exact); the bf16 QuickGELU op by op within an ulp."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    for m in INT8_EDGE_M:
        for k in INT8_EDGE_K:
            for n in INT8_EDGE_N:
                a_q = torch.randint(-127, 128, (m, k), device=cuda_device, dtype=torch.int8,
                                    generator=g)
                w_q = torch.randint(-127, 128, (n, k), device=cuda_device, dtype=torch.int8,
                                    generator=g)
                a_s = (torch.rand(m, 1, device=cuda_device, generator=g) + 0.5) / 127
                w_s = (torch.rand(n, device=cuda_device, generator=g) + 0.5) / (127 * k ** 0.5)
                bias = torch.randn(n, device=cuda_device, generator=g) * 0.1
                res = (torch.randn(m, n, device=cuda_device, generator=g).to(dtype)
                       if epilogue == "dequant_bias_residual" else None)
                args = (a_q, a_s, w_q, w_s, bias, epilogue, dtype)
                got = kernels.gemm_int8_epilogue(*args, residual=res)
                want = kernels.gemm_int8_epilogue_plain(*args, residual=res)
                if epilogue == "dequant_bias_gelu_bf16":
                    _assert_within_an_ulp(got, want)
                else:
                    torch.cuda.synchronize()
                    assert torch.equal(got, want), (m, k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [8, 200, 640, 768, 2560, 3072, 4096])
def test_cuda_quant_rows_widths_match_plain(cuda_device, w):
    """The one-read quantizer at every width class, with a row count that is
    no multiple of a block's rows: mode (b) bit-exact in every quantizer,
    the LayerNorm modes (f32 and bf16 statistics) to their rule."""
    rows = 8 * 197 + 3
    g = torch.Generator(device=cuda_device).manual_seed(w)
    scale = 1 + 0.1 * torch.randn(w, device=cuda_device, generator=g)
    bias = 0.1 * torch.randn(w, device=cuda_device, generator=g)
    for dtype in (torch.bfloat16, torch.float32):
        x = (torch.randn(rows, w, device=cuda_device, generator=g) * 3 + 0.5).to(dtype)
        for mode in kernels._QUANT_MODES:
            for got, want in zip(kernels.quant_rows(x, mode), kernels.quant_rows_plain(x, mode)):
                torch.cuda.synchronize()
                assert torch.equal(got, want), (dtype, mode)
            for bf16_stats in (False, True):
                _assert_ln_quant_close(
                    kernels.layernorm_quant_rows(x, scale, bias, mode=mode, bf16_stats=bf16_stats),
                    kernels.layernorm_quant_rows_plain(x, scale, bias, mode=mode,
                                                       bf16_stats=bf16_stats),
                    bf16_stats)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_cuda_resnet_tower_matches_cpu(cuda_device, dtype):
    """RN50's image tower (width 64, layers 3-4-6-3, 224 px; seeded random
    weights) on the card, cuDNN convolutions in channels_last, against the
    same weights in fp32 on the CPU: in fp32 (TF32 off) within 1e-3 of
    max|ref| and a cosine >= 0.99999; in bf16 a row cosine >= 0.999, with
    the residual branches damped (every bn3 scale x 0.25): undamped, the
    init doubles the activations' variance at every residual add and the
    attention pool is close to an argmax that bf16 rounding moves."""
    from protoclip_tpu_torch.data import normalize_batch
    from protoclip_tpu_torch.models import clip, resnet

    cfg = clip.BACKBONE_CONFIGS["RN50"]
    visual = resnet.init_resnet_params(np.random.default_rng(0), cfg)
    if dtype == torch.bfloat16:
        for i in range(1, 5):
            for block in visual[f"layer{i}"]:
                block["bn3"]["scale"] = block["bn3"]["scale"] * 0.25
    cpu = {"visual": visual}
    card = clip.to_device(clip.cast_params(cpu, dtype), cuda_device)
    images = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (4, 224, 224, 3),
                                                                dtype=np.uint8))
    with torch.inference_mode():
        ref = clip.encode_image(cpu, normalize_batch(images, torch.float32), cfg).double()
        out = clip.encode_image(card, normalize_batch(images.to(cuda_device), dtype), cfg)
        torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (4, cfg.embed_dim)
    out = out.double().cpu()
    if dtype == torch.float32:
        assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-3
        assert float(out.flatten() @ ref.flatten() / (out.norm() * ref.norm())) >= 0.99999
    else:
        assert float(torch.nn.functional.cosine_similarity(out, ref, dim=-1).min()) >= 0.999


def _train_problem(n_class=20, k_shots=4, d=64, seed=0):
    """Class-direction features plus noise, as the CPU trainer tests draw them."""
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((n_class, d)).astype(np.float32)
    protos /= np.linalg.norm(protos, axis=-1, keepdims=True)
    keys = protos.repeat(k_shots, 0) + 0.1 * rng.standard_normal((n_class * k_shots, d),
                                                                 dtype=np.float32)
    keys /= np.linalg.norm(keys, axis=-1, keepdims=True)
    return keys, protos + 0.05 * rng.standard_normal((n_class, d), dtype=np.float32)


def _assert_trained_alike(card, cpu, bar=1e-4):
    """The card's trained parameters within ``bar`` of max|parameter| of the
    CPU's: cuBLAS and cuDNN sum in another order than the CPU."""
    from protoclip_tpu_torch.train.episodic import named_leaves

    ref = {n: p.detach() for n, p in named_leaves(cpu.params)}
    scale = max(float(p.abs().max()) for p in ref.values())
    for name, p in named_leaves(card.params):
        assert p.is_cuda
        assert float((p.detach().cpu() - ref[name]).abs().max()) <= bar * scale, name


@pytest.mark.cuda
def test_cuda_episodic_epoch_matches_cpu(cuda_device):
    """One EpisodicTrainer epoch (conv-2x, L1-L3, fp32) on the card against
    the same epoch on the CPU from the same adapter: loss and acc within
    1e-4, parameters within 1e-4 of max|parameter|."""
    from protoclip_tpu_torch.models.adapters import init_adapter
    from protoclip_tpu_torch.train.episodic import EpisodicTrainer

    keys, bank_t = _train_problem()
    adapter = init_adapter(torch.Generator().manual_seed(0), keys.shape[1], "conv-2x")
    args = dict(frozen_keys=keys, bank_t_init=bank_t, n_class=20, k_shots=4,
                adapter_kind="conv-2x", alpha=0.5, beta=12.0, lr=1e-3, train_epoch=10,
                adapter_init=adapter)
    card, cpu = EpisodicTrainer(**args, device=cuda_device), EpisodicTrainer(**args, device="cpu")
    got, want = card.run_epoch(), cpu.run_epoch()
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-4), key
    _assert_trained_alike(card, cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_cuda_qt_step_matches_cpu(cuda_device, dtype):
    """One QTTrainer step on a small ViT (2 layers, width 64) on the card:
    its frozen encode launches K2 once a layer (or K3 in the int8 mode, not
    set here) and leaves the CLIP parameters as they were; against the same
    step in fp32 on the CPU the query features keep a row cosine >= 0.999
    (bf16) / 0.99999 (fp32), the loss and parameters the bars above (bf16:
    1e-2, the features' rounding reaches the adapter's gradient)."""
    from protoclip_tpu_torch.models import clip
    from protoclip_tpu_torch.models.adapters import init_adapter
    from protoclip_tpu_torch.train.qt import QTTrainer

    cfg = clip.CLIPConfig("tiny-vit", embed_dim=64, image_resolution=32, vision_layers=2,
                          vision_width=64, vision_patch_size=16, context_length=16,
                          vocab_size=128, transformer_width=64, transformer_layers=1)
    cpu_params = clip.init_clip_params(np.random.default_rng(0), cfg)
    card_params = clip.to_device(clip.cast_params(cpu_params, dtype), cuda_device)
    before = [t.clone() for t in _tensors(card_params)]
    keys, bank_t = _train_problem(n_class=3, k_shots=2, d=64)
    adapter = init_adapter(torch.Generator().manual_seed(0), 64, "fc")
    args = dict(bank_v_init=keys, bank_t_init=bank_t, n_class=3, k_shots=2, adapter_kind="fc",
                alpha=0.5, beta=5.0, lr=1e-3, train_epoch=4, adapter_init=adapter)
    card = QTTrainer(clip_params=card_params, clip_cfg=cfg, device=cuda_device,
                     compute_dtype="bfloat16" if dtype == torch.bfloat16 else "float32", **args)
    cpu = QTTrainer(clip_params=cpu_params, clip_cfg=cfg, device="cpu", compute_dtype="float32",
                    **args)
    images = np.random.default_rng(1).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    labels = np.asarray([0, 1, 2, 0, 1, 2, 0, 0], np.int32)
    cos = torch.nn.functional.cosine_similarity(card.encode(images).cpu(), cpu.encode(images),
                                                dim=-1)
    assert float(cos.min()) >= (0.999 if dtype == torch.bfloat16 else 0.99999)
    kernels.reset_launch_counts()
    got = card.train_step(images, labels, 6)
    assert kernels.launch_counts()["fused_transformer_block"] == cfg.vision_layers
    want = cpu.train_step(images, labels, 6)
    bar = 1e-2 if dtype == torch.bfloat16 else 1e-4
    assert got["loss"] == pytest.approx(want["loss"], abs=bar)
    _assert_trained_alike(card, cpu, bar)
    for t, b in zip(_tensors(card_params), before):
        assert torch.equal(t, b)


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_classifier_matches_cpu(cuda_device, dtype, tmp_path, monkeypatch):
    """One ``ProtoClipClassifier.infer_canvases`` call on the card (a small
    ViT, 2 layers at width 64, random weights from seed 0) against the same
    call on the CPU in fp32: K2 launched once a layer; feature row cosine >=
    0.99999 (fp32) / 0.999 (bf16); in fp32 ids equal and top-k probabilities
    within 1e-5, in bf16 every class probability within 1e-2; and the CPU's
    top-k on the card's own features within 1e-5, with equal ids."""
    from protoclip_tpu_torch.core.config import Config
    from protoclip_tpu_torch.io.checkpoint import save_checkpoint_triple
    from protoclip_tpu_torch.models import clip
    from protoclip_tpu_torch.models.adapters import adapter_to_torch_state, init_adapter
    from protoclip_tpu_torch.toolkit import ProtoClipClassifier

    cfg = clip.CLIPConfig("tiny-vit", embed_dim=64, image_resolution=32, vision_layers=2,
                          vision_width=64, vision_patch_size=16, context_length=16,
                          vocab_size=128, transformer_width=64, transformer_layers=1)
    monkeypatch.setitem(clip.BACKBONE_CONFIGS, "tiny-vit", cfg)
    rng = np.random.default_rng(0)
    n_class, shots = 6, 2
    paths = [str(tmp_path / f"{s}.pt") for s in ("v", "t", "a")]
    save_checkpoint_triple(*paths, rng.standard_normal((n_class * shots, 64)),
                           rng.standard_normal((n_class, 64)),
                           adapter_to_torch_state(init_adapter(torch.Generator().manual_seed(0),
                                                               64, "fc"), "fc"))
    mapping = {i: f"class_{i}" for i in range(n_class)}
    kw = dict(memory_bank_v_path=paths[0], memory_bank_t_path=paths[1],
              adapter_weights_path=paths[2], class_id_mapping=mapping, max_batch=8,
              batch_buckets=(1, 4))
    args = dict(backbone="tiny-vit", shots=shots, alpha=0.5, beta=5.0, top_k=3)
    card = ProtoClipClassifier(Config(**args, compute_dtype=dtype), device=cuda_device, **kw)
    cpu = ProtoClipClassifier(Config(**args, compute_dtype="float32"), device="cpu", **kw)
    canvases = np.random.default_rng(1).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    kernels.reset_launch_counts()
    probs, ids = card.infer_canvases(canvases)
    assert kernels.launch_counts()["fused_transformer_block"] == cfg.vision_layers
    feats = card._encode(torch.from_numpy(canvases).to(cuda_device)).cpu()
    want = cpu._encode(torch.from_numpy(canvases))
    cos = torch.nn.functional.cosine_similarity(feats, want, dim=-1)
    assert float(cos.min()) >= (0.99999 if dtype == "float32" else 0.999)
    if dtype == "float32":
        want_p, want_i = cpu.infer_canvases(canvases)
        np.testing.assert_array_equal(ids, want_i)
        np.testing.assert_allclose(probs, want_p, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(cpu.model.probs(feats, 0.5, 5.0).numpy(),
                                   cpu.model.probs(want, 0.5, 5.0).numpy(), atol=1e-2, rtol=0)
    cpu_p, cpu_i = cpu._top_k(feats)
    np.testing.assert_array_equal(cpu_i.numpy(), ids)
    np.testing.assert_allclose(cpu_p.numpy(), probs, atol=1e-5, rtol=0)


def _tiny_bundle(tmp_path, int8):
    """A serving bundle of a small ViT (2 layers at width 64, random weights
    from seed 0, bf16) with buckets 1, 4 and 8."""
    from protoclip_tpu_torch.io.export import save_serving_bundle
    from protoclip_tpu_torch.models import clip

    cfg = clip.CLIPConfig("tiny-vit", embed_dim=64, image_resolution=32, vision_layers=2,
                          vision_width=64, vision_patch_size=16, context_length=16,
                          vocab_size=128, transformer_width=64, transformer_layers=1)
    params = clip.cast_params(clip.init_clip_params(np.random.default_rng(0), cfg),
                              torch.bfloat16)
    path = str(tmp_path / "bundle")
    save_serving_bundle(path, cfg, params, batch_size=8, batch_sizes=(1, 4), int8=int8)
    return path


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_cuda_bundle_replays_match_eager_and_buckets_keep_rows(cuda_device, tmp_path, int8):
    """Each bucket of a bundle loaded on the card is a CUDA graph whose
    capture launched the block once a layer (K3 in an int8 bundle); a
    replay equals the eager encode of the same bucket bit for bit; the
    rows of every bucket, full and padded, stay within the JAX bundle bars
    of the largest bucket's (bf16 1e-5; int8 1e-2, row cosine 0.9995)."""
    from protoclip_tpu_torch.io.export import load_serving_bundle, make_encode_fn

    enc = load_serving_bundle(_tiny_bundle(tmp_path, int8), device=cuda_device)
    block = "fused_transformer_block_int8" if int8 else "fused_transformer_block"
    images = np.random.default_rng(1).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    full = enc(images)
    assert full.shape == (8, 64) and full.dtype == np.float32
    eager = make_encode_fn(enc.cfg, int8=int8)
    for size, art in enc.artifacts.items():
        assert isinstance(art.graph, torch.cuda.CUDAGraph)
        assert art.launches_per_replay[block] == enc.cfg.vision_layers
        replayed = art(images[:size])
        want = eager(enc.params, art.input).cpu().numpy()
        np.testing.assert_array_equal(replayed, want)
        for n in {size, max(1, size - 3)}:
            rows = enc(images[:n])
            if int8:
                assert np.abs(rows - full[:n]).max() <= 1e-2
                cos = (rows * full[:n]).sum(-1) / (np.linalg.norm(rows, axis=-1)
                                                   * np.linalg.norm(full[:n], axis=-1))
                assert cos.min() >= 0.9995
            else:
                assert np.abs(rows - full[:n]).max() <= 1e-5


@pytest.mark.cuda
def test_cuda_bundle_capture_failure_raises(cuda_device, tmp_path, monkeypatch):
    """An encode that cannot be captured (it waits for the card) makes the
    load raise, naming the bucket: there is no eager fallback on the card."""
    from protoclip_tpu_torch.io import export

    real = export.make_encode_fn

    def syncing(cfg, normalize=True, int8=None):
        encode = real(cfg, normalize, int8)

        def fn(params, images):
            out = encode(params, images)
            float(out.sum())  # a device-to-host read: not capturable
            return out

        return fn

    path = _tiny_bundle(tmp_path, False)
    monkeypatch.setattr(export, "make_encode_fn", syncing)
    with pytest.raises(RuntimeError, match="capturing the CUDA graph of bucket 8"):
        export.load_serving_bundle(path, device=cuda_device)
    monkeypatch.setattr(export, "make_encode_fn", real)
    enc = export.load_serving_bundle(path, device=cuda_device)  # the card still captures
    assert enc(np.zeros((2, 32, 32, 3), np.uint8)).shape == (2, 64)


def _mesh_clip(device, dtype):
    from protoclip_tpu_torch.models.clip import cast_params, to_device
    from protoclip_tpu_torch.parallel import dryrun

    cfg, params = dryrun._tiny_clip("cpu")
    return cfg, to_device(cast_params(params, dtype), device)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_cuda_mesh_encode_matches_unsharded(cuda_device, monkeypatch, int8):
    """A mesh of one card encodes bit for bit as the unsharded encode (K2,
    or K3 in the int8 mode, once a layer); two shards on the one card
    (``make_mesh(devices=[cuda:0, cuda:0])``) keep a row cosine >= 0.99999."""
    from protoclip_tpu_torch.io.export import make_encode_fn
    from protoclip_tpu_torch.parallel import make_mesh, make_sharded_encode, replicated

    cfg, params = _mesh_clip(cuda_device, torch.bfloat16)
    encode = make_encode_fn(cfg, int8=int8)
    images = np.random.default_rng(2).integers(0, 256, (16, 32, 32, 3), dtype=np.uint8)
    ref = encode(params, torch.from_numpy(images).to(cuda_device))
    for devices in ([cuda_device], [cuda_device, cuda_device]):
        mesh = make_mesh(devices=devices)
        sharded = make_sharded_encode(encode, mesh)
        kernels.reset_launch_counts()
        got = sharded(replicated(mesh).put(params), images)
        counts = kernels.launch_counts()
        block = "fused_transformer_block_int8" if int8 else "fused_transformer_block"
        assert counts[block] == cfg.vision_layers * len(devices)
        if len(devices) == 1:
            assert torch.equal(got, ref)
        else:
            cos = torch.nn.functional.cosine_similarity(got, ref, dim=-1)
            assert float(cos.min()) >= 0.99999


@pytest.mark.cuda
def test_cuda_mesh_nccl_one_rank_qt_step(cuda_device, tmp_path):
    """One NCCL rank (``init_distributed`` over a ``file://`` rendezvous):
    the sharded Q^T step equals the unsharded step bit for bit, and the
    NCCL all_gather of one rank returns the rows."""
    import torch.distributed as dist

    from protoclip_tpu_torch.parallel import init_distributed, make_mesh
    from protoclip_tpu_torch.parallel.sharding import _all_gather_rows
    from protoclip_tpu_torch.train.episodic import named_leaves
    from protoclip_tpu_torch.train.qt import QTTrainer

    cfg, params = _mesh_clip(cuda_device, torch.bfloat16)
    keys, bank_t = _train_problem(n_class=4, k_shots=2, d=32)
    args = dict(clip_params=params, clip_cfg=cfg, bank_v_init=keys, bank_t_init=bank_t,
                n_class=4, k_shots=2, adapter_kind="fc", alpha=0.5, beta=5.0, lr=1e-3,
                train_epoch=4)
    images = np.random.default_rng(3).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    labels = np.asarray([0, 1, 2, 3, 0, 1, 2, 3])
    assert init_distributed(f"file://{tmp_path / 'rendezvous'}", 1, 0) is False
    try:
        assert dist.get_backend() == "nccl"
        meshed = QTTrainer(mesh=make_mesh(), **args)
        alone = QTTrainer(device=cuda_device, **args)
        feats = meshed.encode(images)
        assert torch.equal(_all_gather_rows(feats), feats)
        assert meshed.train_step(images, labels, 8) == alone.train_step(images, labels, 8)
        for (name, a), (_, b) in zip(named_leaves(meshed.params), named_leaves(alone.params)):
            assert torch.equal(a, b), name
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_validate_experiment_vit_b32(cuda_device, monkeypatch, capsys):
    """``scripts.validate_experiment`` at its default, ViT-B/32 (random
    weights, bf16), on the card: the full ``run(only_test=False)`` launches
    K2 (12 a ViT-B/32 image or text encode) and no K3, and its
    ``only_test`` rerun launches nothing and reproduces ``test_acc_fixed``."""
    from protoclip_tpu_torch.memory import banks
    from protoclip_tpu_torch.scripts import validate_experiment
    from protoclip_tpu_torch.train import runner

    monkeypatch.setattr(banks, "tokenize", synthetic_tokenize)
    runs = []
    real_run = runner.run

    def run(cfg, *args, **kwargs):
        kernels.reset_launch_counts()
        result = real_run(cfg, *args, **kwargs)
        torch.cuda.synchronize()
        runs.append((cfg.only_test, kernels.launch_counts(), result))
        return result

    monkeypatch.setattr(runner, "run", run)
    assert validate_experiment.main([]) == 0
    out = capsys.readouterr().out
    assert "acc reproduced" in out and "[validate] backend=cuda" in out
    (first_only_test, first, full), (rerun_only_test, rerun, cached) = runs
    assert (first_only_test, rerun_only_test) == (False, True)
    k2 = first["fused_transformer_block"]
    assert k2 > 0 and k2 % 12 == 0 and first["fused_transformer_block_int8"] == 0, first
    assert not any(rerun.values()), rerun
    assert cached.test_acc_fixed == full.test_acc_fixed and full.best_epoch >= 0


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_cuda_validate_bundle_vit_b16(cuda_device, monkeypatch, int8):
    """``scripts.validate_bundle`` on ViT-B/16 (random weights) at batch 16
    with bucket 8: the reloaded bundle equals the live encode bit for bit,
    the bucket keeps the JAX script's bars, and each replay was captured
    with the block once a layer (K2, or K3 with ``--int8``)."""
    from protoclip_tpu_torch.scripts import validate_bundle

    monkeypatch.delenv("PROTOCLIP_INT8", raising=False)
    argv = ["--batch", "16", "--buckets", "8", "--iters", "2",
            *(["--int8"] if int8 else [])]
    result = validate_bundle.validate(validate_bundle.build_parser().parse_args(argv))
    assert result["failure"] is None
    assert set(result["line"]) == {"bundle_images_per_sec_device_input", "ms_per_batch",
                                   "note", "bucket_8_ms_per_dispatch"}
    block = "fused_transformer_block_int8" if int8 else "fused_transformer_block"
    other = "fused_transformer_block" if int8 else "fused_transformer_block_int8"
    assert sorted(result["per_replay"]) == [8, 16]
    for launches in result["per_replay"].values():
        assert launches[block] == 12 and other not in launches
