"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where CUDA is not available.
These are the card's kernel checks: every kernel, mode and entry against
its plain version, by the rules of ``protoclip_tpu_torch/scripts/_card.py``,
at the block geometries of the backbones and the bench and at each
kernel's ragged edges (``chip_smoke.py`` drives the end-to-end paths and
times each kernel at the main path's batches, holding it there by the same
rules).  The file imports neither JAX nor the JAX package,
so it also runs on a machine that has only PyTorch; there, skip the
JAX-pinning conftest:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from protoclip_tpu_torch.models.layers import init_block_params
from protoclip_tpu_torch.ops import kernels
from protoclip_tpu_torch.scripts import _card
from protoclip_tpu_torch.scripts._env import synthetic_tokenize


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


def _bars(dtype, table=_card.BARS):
    """``table``'s (rel, cos) bars for activations in ``dtype``."""
    return table[str(dtype).removeprefix("torch.")]


def _hold(out, ref, rule):
    """``out`` against its plain version ``ref`` by ``rule`` (a rule of
    :func:`_card.agreement`: "exact", "ulp", "ln_quant", ..., or bars)."""
    torch.cuda.synchronize()
    got = _card.agreement(out, ref, rule)
    assert got["ok"], got


def _hold_refusing(out, ref, fault, rule="eva"):
    """:func:`_hold`, and ``fault``, the plain version with a fault planted
    in it, refused by the same rule."""
    _hold(out, ref, rule)
    planted = _card.agreement(fault, ref, rule)
    assert not planted["ok"], planted


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


# (L, D, heads, causal, a length below L) of the blocks every kernel is held
# at: ViT-B/16, the text tower, ViT-L/14 and ViT-B/32; two small blocks whose
# L is no multiple of a tile (one causal at dh = 64); the block-variant
# bench's padded rows at ViT-B/16 and ViT-L/14 and a tiny one, each with its
# length
GEOMETRIES = {
    "vit_b16": (197, 768, 12, False, 192),
    "text": (77, 512, 8, True, 72),
    "vit_l14": (257, 1024, 16, False, 252),
    "vit_b32": (50, 768, 12, False, 45),
    "small": (50, 128, 2, False, 45),
    "tiny_causal": (13, 64, 1, True, 8),
    "bench_vit_b16": (200, 768, 12, False, 197),
    "bench_vit_l14": (264, 1024, 16, False, 257),
    "bench_tiny": (16, 64, 2, False, 13),
}
CHECK_BATCH = 8
DTYPES = pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])


def _inputs(geom, dtype, device):
    """A block's weights and the activations of the geometry: x, the QKV
    buffer of LN(x) (its column slices, packed and head-major), and
    ``hid``, an fp32 MLP hidden as fc leaves it."""
    L, D, H, _, _ = GEOMETRIES[geom]
    blk = _block(D, dtype, device)
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(CHECK_BATCH, L, D, device=device, generator=g).to(dtype)
    hid = torch.randn(CHECK_BATCH, L, 4 * D, device=device, generator=g)
    ln1 = kernels.layernorm_rows_plain(x, blk["ln_1"]["scale"], blk["ln_1"]["bias"])
    qkv = kernels.gemm_bias_epilogue_plain(ln1, blk["attn"]["wqkv"], blk["attn"]["bqkv"], "bias")
    return blk, x, ln1, qkv, hid


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_cuda_kernels_match_plain(cuda_device, geom, dtype):
    """K2's kernels and entries at the card's bars: LayerNorm, the four
    GEMMs with their epilogues, the attention on column slices of one QKV
    buffer with every key and with a length below L, the K1 entry on packed
    tensors, K4 on head-major ones, and the K2 block whole and pre-padded
    with ``length``; each call counted once under its entry."""
    L, D, H, causal, length = GEOMETRIES[geom]
    bars = _bars(dtype)
    blk, x, ln1, qkv, hid = _inputs(geom, dtype, cuda_device)
    at, mlp = blk["attn"], blk["mlp"]
    hid = hid.to(dtype)
    kernels.reset_launch_counts()
    _hold(kernels.layernorm_rows(x, blk["ln_1"]["scale"], blk["ln_1"]["bias"]), ln1, bars)
    for a, w, b, epi, res in ((ln1, at["wqkv"], at["bqkv"], "bias", None),
                              (ln1, at["wo"], at["bo"], "bias_residual", x),
                              (ln1, mlp["w_fc"], mlp["b_fc"], "bias_gelu", None),
                              (hid, mlp["w_proj"], mlp["b_proj"], "bias_residual", x)):
        _hold(kernels.gemm_bias_epilogue(a, w, b, epi, residual=res),
              kernels.gemm_bias_epilogue_plain(a, w, b, epi, residual=res), bars)
    sl, packed, heads = _packed_and_heads(qkv, H)
    for n in (L, length):
        _hold(kernels.attention_packed(*sl, H, causal, n),
              kernels.fused_attention_packed_plain(*sl, H, causal, n), bars)
    _hold(kernels.fused_attention_packed(*packed, H, causal),
          kernels.fused_attention_packed_plain(*packed, H, causal), bars)
    _hold(kernels.fused_attention(*heads, causal), kernels.fused_attention_plain(*heads, causal),
          bars)
    _hold(kernels.fused_transformer_block(x, blk, H, causal),
          kernels.fused_transformer_block_plain(x, blk, H, causal), bars)
    xp = F.pad(x, (0, 0, 0, 3))
    _hold(kernels.fused_transformer_block(xp, blk, H, causal, length=L),
          kernels.fused_transformer_block_plain(xp, blk, H, causal, length=L), bars)
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    assert launched == {
        "layernorm_rows": 1 + 4, "gemm_bias_epilogue": 4 + 8, "attention_packed": 2 + 1 + 2,
        "fused_attention_packed": 1, "fused_attention": 1, "fused_transformer_block": 2,
    }


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_cuda_int8_kernels_match_plain(cuda_device, geom, dtype):
    """K3's pieces as its chain feeds them: ``quant_rows`` (mode b) on the
    attention output and on the fp32 hidden and the four int8 GEMMs with
    their epilogues, bit-exact; the LayerNorm quantizer (mode a) to its
    step rule; and the K3 block, whole and pre-padded, at K3's bars."""
    L, D, H, causal, _ = GEOMETRIES[geom]
    blk, x, _, qkv, hid = _inputs(geom, dtype, cuda_device)
    q = kernels.quantize_block(blk)
    sl, _, _ = _packed_and_heads(qkv, H)
    attn = kernels.fused_attention_packed_plain(*sl, H, causal)
    kernels.reset_launch_counts()
    for t in (attn, hid):
        _hold(kernels.quant_rows(t), kernels.quant_rows_plain(t), "exact")
    _hold(kernels.layernorm_quant_rows(x, q["ln1s"], q["ln1b"]),
          kernels.layernorm_quant_rows_plain(x, q["ln1s"], q["ln1b"]), "ln_quant")
    h_q = kernels.layernorm_quant_rows_plain(x, q["ln1s"], q["ln1b"])
    a_q, hid_q = kernels.quant_rows_plain(attn), kernels.quant_rows_plain(hid)
    for (aq, a_s), w, epi, res in ((h_q, "qkv", "dequant_bias", None),
                                   (a_q, "o", "dequant_bias_residual", x),
                                   (h_q, "fc", "dequant_bias_gelu", None),
                                   (hid_q, "proj", "dequant_bias_residual", x)):
        args = (aq, a_s, q["w" + w], q["s" + w], q["b" + w], epi, dtype)
        _hold(kernels.gemm_int8_epilogue(*args, residual=res),
              kernels.gemm_int8_epilogue_plain(*args, residual=res), "exact")
    bars = _bars(dtype, _card.INT8_BLOCK_BARS)
    _hold(kernels.fused_transformer_block_int8(x, q, H, causal),
          kernels.fused_transformer_block_int8_plain(x, q, H, causal), bars)
    xp = F.pad(x, (0, 0, 0, 3))
    _hold(kernels.fused_transformer_block_int8(xp, q, H, causal, length=L),
          kernels.fused_transformer_block_int8_plain(xp, q, H, causal, length=L), bars)
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    assert launched == {
        "quant_rows": 2 + 4, "layernorm_quant_rows": 1 + 4, "gemm_int8_epilogue": 4 + 8,
        "attention_packed": 2, "fused_transformer_block_int8": 2,
    }


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_cuda_bench_modes_and_kernels_match_plain(cuda_device, geom, dtype):
    """The block-variant bench's modes and its two kernels: the attention's
    q_round and no_softmax modes with every key and with the length, at the
    card's bars; ``attention_int8`` with a v scale per 1, 2 and 4 batch
    elements (bit-exact, or within two steps of v_amax / 127); ``qkv_sum``
    and every quantizer mode bit-exact; the LayerNorm quantizer's modes and
    its bf16 statistics to the step rule; the bf16 GEMM's bench epilogues
    at the card's bars; and the int8 epilogues bit-exact, the bf16
    QuickGELU within an ulp."""
    L, D, H, causal, length = GEOMETRIES[geom]
    bars = _bars(dtype)
    blk, x, ln1, qkv, hid = _inputs(geom, dtype, cuda_device)
    q = kernels.quantize_block(blk)
    sl, _, _ = _packed_and_heads(qkv, H)
    attn = kernels.fused_attention_packed_plain(*sl, H, causal)
    kernels.reset_launch_counts()
    for mode in ("q_round", "no_softmax"):
        for n in (L, length):
            _hold(kernels.attention_packed(*sl, H, causal, n, mode),
                  kernels.fused_attention_packed_plain(*sl, H, causal, n, mode), bars)
    for group in (1, 2, 4):
        _hold(kernels.attention_int8(*sl, H, length, group),
              kernels.attention_int8_plain(*sl, H, length, group), _card.int8_attention_rule(sl[2]))
    _hold(kernels.qkv_sum(qkv), kernels.qkv_sum_plain(qkv), "exact")
    for mode in ("recip", "static", "cast"):
        for t in (attn, hid):
            _hold(kernels.quant_rows(t, mode), kernels.quant_rows_plain(t, mode), "exact")
        _hold(kernels.layernorm_quant_rows(x, q["ln1s"], q["ln1b"], mode=mode),
              kernels.layernorm_quant_rows_plain(x, q["ln1s"], q["ln1b"], mode=mode), "ln_quant")
    _hold(kernels.layernorm_quant_rows(x, q["ln1s"], q["ln1b"], bf16_stats=True),
          kernels.layernorm_quant_rows_plain(x, q["ln1s"], q["ln1b"], bf16_stats=True),
          "ln_quant")
    # the bf16 GEMM sums in another order, so T(acc + b) may differ by an
    # ulp before QuickGELU: the GEMM's bars; the int8 epilogue below has an
    # exact accumulator and meets the ulp rule
    fc = (ln1, blk["mlp"]["w_fc"], blk["mlp"]["b_fc"], "bias_gelu_bf16")
    _hold(kernels.gemm_bias_epilogue(*fc), kernels.gemm_bias_epilogue_plain(*fc), bars)
    w_down = (q["wproj"].t().to(dtype) * q["sproj"].to(dtype)).contiguous()
    down = (hid.to(dtype), w_down, q["bproj"], "bias32_residual", x)
    _hold(kernels.gemm_bias_epilogue(*down), kernels.gemm_bias_epilogue_plain(*down), bars)
    h_q = kernels.layernorm_quant_rows_plain(x, q["ln2s"], q["ln2b"])
    for epi in ("dequant_bias_gelu_bf16", "dequant_bias_f32", "dequant_bias_gelu_round"):
        args = (*h_q, q["wfc"], q["sfc"], q["bfc"], epi, dtype)
        _hold(kernels.gemm_int8_epilogue(*args), kernels.gemm_int8_epilogue_plain(*args),
              "ulp" if epi == "dequant_bias_gelu_bf16" else "exact")
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    assert launched == {
        "attention_packed": 4, "attention_packed.q_round": 2, "attention_packed.no_softmax": 2,
        "attention_int8": 3, "qkv_sum": 1,
        "quant_rows": 6, "quant_rows.recip": 2, "quant_rows.static": 2, "quant_rows.cast": 2,
        "layernorm_quant_rows": 4, "layernorm_quant_rows.recip": 1,
        "layernorm_quant_rows.static": 1, "layernorm_quant_rows.cast": 1,
        "layernorm_quant_rows.bf16_stats": 1,
        "gemm_bias_epilogue": 2, "gemm_bias_epilogue.bias_gelu_bf16": 1,
        "gemm_bias_epilogue.bias32_residual": 1,
        "gemm_int8_epilogue": 3, "gemm_int8_epilogue.dequant_bias_gelu_bf16": 1,
        "gemm_int8_epilogue.dequant_bias_f32": 1, "gemm_int8_epilogue.dequant_bias_gelu_round": 1,
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
    # bf16 streams K and V through a ring of fixed size: its shared memory
    # does not grow with L, so L = 577 and L = 1024 at dh = 128 launch
    lib = kernels._build.load_library()
    assert lib.attention_packed_smem_bytes(1, 1024, 128) == lib.attention_packed_smem_bytes(
        1, 64, 128) <= kernels.SMEM_PER_BLOCK
    for L in (577, 1024):
        x = torch.randn(1, L, 128, device=cuda_device).to(torch.bfloat16)
        _hold(kernels.attention_packed(x, x, x, 1),
              kernels.fused_attention_packed_plain(x, x, x, 1), _bars(torch.bfloat16))
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
    _hold(bench.stack_output(prep, bv.KERNEL_OPS), bench.stack_output(prep, bv.PLAIN_OPS),
          (5e-2, 0.999) if "int8" in name else (2e-2, 0.9999))


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("L,causal", [(1, False), (16, False), (17, False), (63, False),
                                      (65, True), (77, True), (129, False), (197, False),
                                      (257, False), (264, False)])
def test_cuda_attention_edges_match_plain(cuda_device, L, causal, dh):
    """The attention's edges, in bf16 (tensor cores) and fp32 (the tiled
    CUDA-core kernel): a single row, one and a bit of a 16-key tile, one
    short of and one past a 64-row query tile (bf16: a 16-key last tile),
    two tiles and a row, the text block's causal L, the image lengths and
    the bench's ViT-L/14 264 (fp32: one to five 64-row query tiles and
    64-key chunks, L = 257 at dh = 128 included), dh padded to 32/64/128, a
    length below L, both bench modes, and all three stride layouts (QKV
    slices, packed K1, head-major K4); each call counted once under its
    entry and mode."""
    H = 2
    g = torch.Generator(device=cuda_device).manual_seed(L * 1000 + dh)
    kernels.reset_launch_counts()
    lengths = sorted({L, max(1, L - 5)})
    for dtype in (torch.bfloat16, torch.float32):
        qkv = torch.randn(3, L, 3 * H * dh, device=cuda_device, generator=g).to(dtype)
        sl, packed, heads = _packed_and_heads(qkv, H)
        for length in lengths:
            for mode in ("softmax", "q_round", "no_softmax"):
                _hold(kernels.attention_packed(*sl, H, causal, length, mode),
                      kernels.fused_attention_packed_plain(*sl, H, causal, length, mode),
                      _bars(dtype))
        _hold(kernels.fused_attention_packed(*packed, H, causal),
              kernels.fused_attention_packed_plain(*packed, H, causal), _bars(dtype))
        _hold(kernels.fused_attention(*heads, causal),
              kernels.fused_attention_plain(*heads, causal), _bars(dtype))
    counts = kernels.launch_counts()
    assert counts["attention_packed"] == 2 * (3 * len(lengths) + 1)
    assert counts["attention_packed.q_round"] == counts["attention_packed.no_softmax"] == \
        2 * len(lengths)
    assert counts["fused_attention_packed"] == 2 and counts["fused_attention"] == 2


# the int8 attention core's edges: one row, a 16-row warp tile and one past
# it, the text length, the bench's padded image rows and ViT-L/14's 257 and
# 264; every head width class of the 32-byte k-step (8 ... 128), and 16, one
# 16-byte piece of bf16
INT8_ATTENTION_L = (1, 15, 16, 17, 77, 200, 257, 264)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [8, 16, 24, 32, 64, 128])
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
                _hold(kernels.attention_int8(*sl, H, length, group),
                      kernels.attention_int8_plain(*sl, H, length, group),
                      _card.int8_attention_rule(sl[2]))
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
    _hold(out, kernels.gemm_bias_epilogue_plain(a, w, bias, epilogue, res), _bars(dtype))


# the fp32 GEMM's edges (128 x 128 tiles, 32-deep K steps): one row, 7 rows
# and a ragged 8 x 197; K under one 32-value swizzle row, ragged, and the
# proj width; N one 8-column piece, a tile and a half, ViT-B/16's QKV width
FP32_EDGE_M = (1, 7, 8 * 197)
FP32_EDGE_K = (8, 200, 3072)
FP32_EDGE_N = (8, 192, 2304)


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", ["bias", "bias_residual", "bias_gelu", "bias_gelu_bf16",
                                      "bias32_residual"])
def test_cuda_fp32_gemm_edges_match_plain(cuda_device, epilogue):
    """The fp32 GEMM where M, K and N are not multiples of its tile (TMA
    zero-fills the reads past them, the epilogue masks the writes), each
    epilogue with its residual, at the fp32 bars; each call counted once,
    and once more under a bench epilogue's own name."""
    g = torch.Generator(device=cuda_device).manual_seed(17)
    kernels.reset_launch_counts()
    calls = 0
    for m in FP32_EDGE_M:
        for k in FP32_EDGE_K:
            for n in FP32_EDGE_N:
                a = torch.randn(m, k, device=cuda_device, generator=g)
                w = torch.randn(k, n, device=cuda_device, generator=g) * k ** -0.5
                bias = torch.randn(n, device=cuda_device, generator=g) * 0.1
                res = (torch.randn(m, n, device=cuda_device, generator=g)
                       if epilogue in ("bias_residual", "bias32_residual") else None)
                out = kernels.gemm_bias_epilogue(a, w, bias, epilogue, res)
                assert out.shape == (m, n) and out.dtype == torch.float32
                _hold(out, kernels.gemm_bias_epilogue_plain(a, w, bias, epilogue, res),
                      _bars(torch.float32))
                calls += 1
    counts = kernels.launch_counts()
    assert counts["gemm_bias_epilogue"] == calls
    if epilogue in ("bias_gelu_bf16", "bias32_residual"):
        assert counts["gemm_bias_epilogue." + epilogue] == calls


def backbone_attention_shapes():
    """(backbone, tower, L, head dim) of every transformer a backbone runs
    K2 on: the text tower, and the image tower of the ViTs."""
    from protoclip_tpu_torch.models import BACKBONE_CONFIGS

    shapes = []
    for name, cfg in BACKBONE_CONFIGS.items():
        shapes.append((name, "text", cfg.context_length,
                       cfg.transformer_width // cfg.transformer_heads))
        if cfg.is_vit:
            grid = cfg.image_resolution // cfg.vision_patch_size
            shapes.append((name, "image", grid * grid + 1, cfg.vision_width // cfg.vision_heads))
    return shapes


@pytest.mark.cuda
@pytest.mark.parametrize("backbone,tower,L,dh", backbone_attention_shapes())
def test_cuda_fp32_attention_smem_fits_every_backbone(cuda_device, backbone, tower, L, dh):
    """The fp32 attention's shared memory, as the C entry reports it to the
    wrapper's guard, fits one block's opt-in 232,448 bytes at every
    backbone tower: it grows with L only through the 64 x L score tile
    (169,984 bytes at the kernel's stated L = 264, dh = 128)."""
    from protoclip_tpu_torch.ops import _build

    lib = _build.load_library()
    assert lib.attention_packed_smem_bytes(0, L, dh) <= kernels.SMEM_PER_BLOCK
    assert lib.attention_packed_smem_bytes(0, 264, 128) == 169_984


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
                _hold(kernels.gemm_int8_epilogue(*args, residual=res),
                      kernels.gemm_int8_epilogue_plain(*args, residual=res),
                      "ulp" if epilogue == "dequant_bias_gelu_bf16" else "exact")


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
            _hold(kernels.quant_rows(x, mode), kernels.quant_rows_plain(x, mode), "exact")
            for bf16_stats, rule in ((False, "ln_quant"), (True, "ln_quant_bf16_stats")):
                _hold(kernels.layernorm_quant_rows(x, scale, bias, mode=mode,
                                                   bf16_stats=bf16_stats),
                      kernels.layernorm_quant_rows_plain(x, scale, bias, mode=mode,
                                                         bf16_stats=bf16_stats), rule)


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


@pytest.mark.cuda
def test_cuda_ragged_bank_batch_matches_the_padded_call(cuda_device, monkeypatch):
    """The bank build's short batch through the runner's encode (ViT-B/16,
    random weights, K2 in bf16): its 96 valid rows encoded alone equal the
    first 96 rows of the 1024-row call padded with zero rows, bit for bit."""
    from protoclip_tpu_torch.core.config import Config
    from protoclip_tpu_torch.models import clip
    from protoclip_tpu_torch.train.runner import make_encode_fns

    monkeypatch.setattr(clip, "find_weights", lambda backbone: None)
    monkeypatch.delenv("PROTOCLIP_STRICT_WEIGHTS", raising=False)
    encode = make_encode_fns(Config(backbone="ViT-B/16"), device=cuda_device, int8=False)[0]
    images = np.random.default_rng(3).integers(0, 256, (96, 224, 224, 3), dtype=np.uint8)
    padded = np.concatenate([images, np.zeros((928, 224, 224, 3), np.uint8)])
    kernels.reset_launch_counts()
    got, want = encode(images), encode(padded)[:96]
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_transformer_block"] == 24
    diff = float((got.float() - want.float()).abs().max())
    assert torch.equal(got, want), f"max |diff| {diff} over max |row| {float(want.abs().max())}"


# -- EVA02-CLIP-L/14-336 ---------------------------------------------------------------------


def _eva_reference():
    """``tests/eva_reference.py``, loaded by its path: a package named
    ``tests`` elsewhere on the path may shadow this directory."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "eva_reference", Path(__file__).with_name("eva_reference.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _eva_block(d, hidden, device, seed=0):
    """One EVA02 layer converted from a seeded EVA-CLIP state dict, in bf16
    with fp32 LayerNorms."""
    from protoclip_tpu_torch.models import clip, eva

    ref = _eva_reference()
    t = dict(ref.TINY, width=d, heads=d // 64, layers=1, hidden=hidden, px=14 * 4)
    sd = ref.eva_state_dict(seed, t, buffers=False)
    cfg = clip.infer_config_from_state_dict(sd)
    vis = clip.cast_params(eva.visual_from_state_dict({k: v.numpy() for k, v in sd.items()}, cfg),
                           torch.bfloat16)
    return clip.to_device(vis["blocks"][0], device)


@pytest.mark.cuda
@pytest.mark.parametrize("b,L,D,hidden", [(2, 577, 1024, 2730), (3, 17, 128, 341)])
def test_cuda_eva_kernels_match_plain(cuda_device, b, L, D, hidden):
    """Each EVA02 kernel and mode against its plain version, twice.  First
    on random-normal activations and the layer's own weights at the card's
    bf16 bars: the RoPE QKV epilogue (its class token and v against the
    plain bias epilogue), the SwiGLU epilogue (a ragged hidden padded to a
    multiple of 8), the hidden's sub-LN over a row wider than its valid
    width (padded lanes 0), the attention output's LN on ``layernorm_rows``
    at EVA02's eps.  Then by the EVA02 rule (``_card.eva_agreement``: the
    bf16 bars, and >= 99.9% of the outputs bit for bit), which must refuse
    a fault planted in the plain version: the RoPE QKV epilogue on values
    whose products sum exactly (fault: the class token turned by the last
    patch's angles), its class token and v against the plain bias epilogue
    (an ulp at most); the SwiGLU epilogue on such values (w1 and w2
    traded); the sub-LN (statistics over the stride); the attention
    output's LN on values of its size (eps 1e-5).  Last the whole block at
    the bf16 bars.  Each part with its launches."""
    from protoclip_tpu_torch.models import eva

    bf16, h, hp = torch.bfloat16, D // 64, eva.padded_hidden(hidden)
    blk = _eva_block(D, hidden, cuda_device)
    grid = int(round((L - 1) ** 0.5))
    cos, sin = (t.to(cuda_device) for t in eva.rope_tables(grid, 16, 64))
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(b, L, D, device=cuda_device, generator=g).to(bf16)
    kernels.reset_launch_counts()
    at, mlp = blk["attn"], blk["mlp"]
    out = kernels.gemm_bias_rope(x, at["wqkv"], at["bqkv"], cos, sin, 2 * D)
    _hold(out, kernels.gemm_bias_rope_plain(x, at["wqkv"], at["bqkv"], cos, sin, 2 * D),
          _bars(bf16))
    plain = kernels.gemm_bias_epilogue_plain(x, at["wqkv"], at["bqkv"], "bias")
    _hold(out[:, 0], plain[:, 0], _bars(bf16))
    _hold(out[..., 2 * D:], plain[..., 2 * D:], _bars(bf16))
    hid = kernels.gemm_bias_swiglu(x, mlp["w12"], mlp["b12"])
    assert hid.shape == (b, L, hp) and not hid[..., hidden:].any()
    _hold(hid, kernels.gemm_bias_swiglu_plain(x, mlp["w12"], mlp["b12"]), _bars(bf16))
    ffn = mlp["ln_ffn"]
    noisy = hid.clone()
    noisy[..., hidden:] = 100.0
    sub = kernels.layernorm_sub_rows(noisy, ffn["scale"], ffn["bias"])
    assert not sub[..., hidden:].any()
    _hold(sub, kernels.layernorm_sub_rows_plain(noisy, ffn["scale"], ffn["bias"]), _bars(bf16))
    inner, eps = at["ln_inner"], kernels.EVA_LN_EPS
    _hold(kernels.layernorm_rows(x, inner["scale"], inner["bias"], eps),
          kernels.layernorm_rows_plain(x, inner["scale"], inner["bias"], eps), _bars(bf16))
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    assert launched == {"gemm_bias_epilogue": 2, "gemm_bias_epilogue.bias_rope": 1,
                        "gemm_bias_epilogue.bias_swiglu": 1, "layernorm_sub_rows": 1,
                        "layernorm_rows": 1}
    kernels.reset_launch_counts()
    ea = _card.exact_sum_values(g, (b, L, D), 8, 1 / 16)
    ew = _card.exact_sum_values(g, (D, 3 * D), 2, 1 / 16)
    eb = _card.exact_sum_values(g, (3 * D,), 64, 1 / 256)
    rope = kernels.gemm_bias_rope_plain(ea, ew, eb, cos, sin, 2 * D)
    cls_turned = rope.clone()
    cls_turned[:, 0] = kernels.gemm_bias_rope_plain(ea[:, [0, 0]], ew, eb, cos[-1:], sin[-1:],
                                                    2 * D)[:, 1]
    out = kernels.gemm_bias_rope(ea, ew, eb, cos, sin, 2 * D)
    _hold_refusing(out, rope, cls_turned)
    plain = kernels.gemm_bias_epilogue_plain(ea, ew, eb, "bias")
    # T(acc + b) against T(T(acc) + b): the class token and v differ by an ulp at most
    _hold(out[:, 0], plain[:, 0], _bars(bf16))
    _hold(out[..., 2 * D:], plain[..., 2 * D:], _bars(bf16))
    ew = _card.exact_sum_values(g, (D, 2 * hp), 2, 1 / 16)
    eb = _card.exact_sum_values(g, (2 * hp,), 64, 1 / 256)
    ew[:, 2 * hidden:], eb[2 * hidden:] = 0, 0  # the padded hidden, as models/eva.py pads it

    def turn_pairs(t):  # w1 and w2 trade places in the interleaved (..., 2H)
        return t.unflatten(-1, (hp, 2)).flip(-1).flatten(-2)

    hid = kernels.gemm_bias_swiglu(ea, ew, eb)
    assert hid.shape == (b, L, hp) and not hid[..., hidden:].any()
    _hold_refusing(hid, kernels.gemm_bias_swiglu_plain(ea, ew, eb),
                   kernels.gemm_bias_swiglu_plain(ea, turn_pairs(ew), turn_pairs(eb)))
    noisy = hid.clone()
    noisy[..., hidden:] = 100.0
    sub = kernels.layernorm_sub_rows(noisy, ffn["scale"], ffn["bias"])
    assert not sub[..., hidden:].any()
    over_stride = kernels.layernorm_rows_plain(hid, F.pad(ffn["scale"], (0, hp - hidden)),
                                               F.pad(ffn["bias"], (0, hp - hidden)),
                                               kernels.EVA_LN_EPS)
    over_stride[..., hidden:] = 0
    _hold_refusing(sub, kernels.layernorm_sub_rows_plain(noisy, ffn["scale"], ffn["bias"]),
                   over_stride)
    # values of an attention output's size (v averaged over the tokens),
    # where eps = 1e-5 shows
    o = (0.01 * torch.randn(b, L, D, device=cuda_device, generator=g)).to(bf16)
    _hold_refusing(kernels.layernorm_rows(o, inner["scale"], inner["bias"], eps),
                   kernels.layernorm_rows_plain(o, inner["scale"], inner["bias"], eps),
                   kernels.layernorm_rows_plain(o, inner["scale"], inner["bias"]))
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    assert launched == {"gemm_bias_epilogue": 2, "gemm_bias_epilogue.bias_rope": 1,
                        "gemm_bias_epilogue.bias_swiglu": 1, "layernorm_sub_rows": 1,
                        "layernorm_rows": 1}
    x = torch.randn(b, L, D, device=cuda_device, generator=g).to(bf16)
    kernels.reset_launch_counts()
    _hold(kernels.fused_eva_block(x, blk, h, cos, sin),
          kernels.fused_eva_block_plain(x, blk, h, cos, sin), _bars(bf16))
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    assert launched == {
        "layernorm_rows": 3, "layernorm_sub_rows": 1, "gemm_bias_epilogue": 4,
        "gemm_bias_epilogue.bias_rope": 1, "gemm_bias_epilogue.bias_swiglu": 1,
        "attention_packed": 1, "fused_eva_block": 1,
    }


@pytest.mark.cuda
@DTYPES
def test_cuda_exact_gelu_epilogue_and_sub_ln_match_plain(cuda_device, dtype):
    """The text MLP's exact-GELU fc epilogue at the EVA02-CLIP text width
    (77 tokens, 768 -> 3072), in both activation dtypes: on random-normal
    values and weights at the card's bars, and on values whose products sum
    exactly, in bf16 by the EVA02 rule and in fp32 at the fp32 bars,
    refusing its planted fault (the tanh GELU); the sub-LN over 700 of 768
    lanes by the same rule, refusing statistics over the whole row; then
    the text block with the exact GELU, causal, at the card's bars."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    rule = "eva" if dtype == torch.bfloat16 else _bars(dtype)
    a = torch.randn(4, 77, 768, device=cuda_device, generator=g).to(dtype)
    w = (torch.randn(768, 3072, device=cuda_device, generator=g) * 768 ** -0.5).to(dtype)
    bias = (torch.randn(3072, device=cuda_device, generator=g) * 0.1).to(dtype)
    kernels.reset_launch_counts()
    _hold(kernels.gemm_bias_epilogue(a, w, bias, "bias_gelu_erf"),
          kernels.gemm_bias_epilogue_plain(a, w, bias, "bias_gelu_erf"), _bars(dtype))
    a = _card.exact_sum_values(g, (4, 77, 768), 8, 1 / 16).to(dtype)
    w = _card.exact_sum_values(g, (768, 3072), 2, 1 / 16).to(dtype)
    bias = _card.exact_sum_values(g, (3072,), 64, 1 / 256).to(dtype)
    acc = torch.matmul(a.float(), w.float()) + bias.float()
    _hold_refusing(kernels.gemm_bias_epilogue(a, w, bias, "bias_gelu_erf"),
                   kernels.gemm_bias_epilogue_plain(a, w, bias, "bias_gelu_erf"),
                   F.gelu(acc, approximate="tanh").to(dtype), rule)
    x = torch.randn(4, 77, 768, device=cuda_device, generator=g).to(dtype)
    scale = torch.rand(700, device=cuda_device, generator=g) + 0.5
    shift = torch.randn(700, device=cuda_device, generator=g) * 0.1
    whole_row = kernels.layernorm_rows_plain(x, F.pad(scale, (0, 68)), F.pad(shift, (0, 68)),
                                             kernels.EVA_LN_EPS)
    whole_row[..., 700:] = 0
    _hold_refusing(kernels.layernorm_sub_rows(x, scale, shift),
                   kernels.layernorm_sub_rows_plain(x, scale, shift), whole_row, rule)
    blk = _block(768, dtype, cuda_device)
    _hold(kernels.fused_transformer_block(x, blk, 12, True, act="gelu"),
          kernels.fused_transformer_block_plain(x, blk, 12, True, act="gelu"), _bars(dtype))
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    assert launched["gemm_bias_epilogue.bias_gelu_erf"] == 3
    assert launched["layernorm_sub_rows"] == 1


@pytest.mark.cuda
def test_cuda_attention_at_577_tokens_fits_shared_memory(cuda_device):
    """EVA02-L/14 at 336 px: L = 577, dh = 64.  The bf16 attention streams K
    and V through a ring: an 8 KB Q tile and four 8 KB stages, 41,984 bytes
    with the alignment slack, whatever L, so four blocks fit an SM.  Against
    its plain version, with the K2 bars."""
    from protoclip_tpu_torch.ops import _build

    assert _build.load_library().attention_packed_smem_bytes(1, 577, 64) == 41_984
    assert 4 * 41_984 <= kernels.SMEM_PER_BLOCK
    g = torch.Generator(device=cuda_device).manual_seed(3)
    qkv = torch.randn(4, 577, 3 * 1024, device=cuda_device, generator=g).to(torch.bfloat16)
    q, k, v = qkv[..., :1024], qkv[..., 1024:2048], qkv[..., 2048:]
    _hold(kernels.attention_packed(q, k, v, 16),
          kernels.fused_attention_packed_plain(q, k, v, 16), _bars(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,dh,causal", [(4, 577, 16, 64, False), (4, 257, 16, 64, False),
                                             (16, 77, 8, 64, True), (2, 577, 8, 128, False),
                                             (2, 1024, 4, 128, True)])
def test_cuda_attention_at_backbone_geometries_matches_plain(cuda_device, B, L, H, dh, causal):
    """The bf16 attention at the backbones' geometries: EVA02's L = 577 (ten
    64-row query tiles, K and V streamed, a 16-key last tile), ViT-L/14's
    257, the text tower's causal 77 and dh = 128 at
    L = 577 and 1024, in its three modes and with two lengths below L (the
    last 5 keys masked, and the last 70), against its plain version with
    the K2 bars."""
    g = torch.Generator(device=cuda_device).manual_seed(L * 100 + dh)
    qkv = torch.randn(B, L, 3 * H * dh, device=cuda_device, generator=g).to(torch.bfloat16)
    d = H * dh
    sl = (qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:])
    for length in (L, L - 5, L - 70):
        for mode in ("softmax", "q_round", "no_softmax"):
            _hold(kernels.attention_packed(*sl, H, causal, length, mode),
                  kernels.fused_attention_packed_plain(*sl, H, causal, length, mode),
                  _bars(torch.bfloat16))


@pytest.mark.cuda
def test_cuda_eva_tower_matches_the_fp32_reference(cuda_device, tmp_path):
    """EVA02-CLIP-L/14-336 at its published widths through load_clip (a
    seeded state dict in EVA-CLIP's layout), B = 16 in bf16, against the
    plain fp32 reference on the card (TF32 off).  Bar: the worst row's
    relative error under 5e-2, bf16 through 24 blocks (cosine 0.999)."""
    from protoclip_tpu_torch.data.transforms import normalize_batch
    from protoclip_tpu_torch.models import clip

    ref_module = _eva_reference()
    full = dict(ref_module.TINY, width=1024, heads=16, layers=24, px=336, hidden=2730, embed=768,
                text_width=768, text_heads=12, text_layers=12, vocab=49408, context=77)
    sd = ref_module.eva_state_dict(4, full)
    path = tmp_path / "eva02_l14_336.pt"
    torch.save(sd, path)
    cfg, params = clip.load_clip("EVA02-CLIP-L-14-336", str(path), device=cuda_device, int8=False)
    assert cfg == clip.PORT_BACKBONE_CONFIGS["EVA02-CLIP-L-14-336"]
    g = torch.Generator(device=cuda_device).manual_seed(5)
    images = torch.randint(0, 256, (16, 336, 336, 3), device=cuda_device, generator=g,
                           dtype=torch.uint8)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        port = clip.encode_image(params, normalize_batch(images, torch.bfloat16), cfg).double()
    counts = kernels.launch_counts()
    assert counts["fused_eva_block"] == 24 and counts["layernorm_sub_rows"] == 24
    del params
    torch.cuda.empty_cache()
    ref = ref_module.EvaCLIP(sd, 16, 12, 16, device="cuda").encode_image(
        normalize_batch(images)).double()
    err = float(((port - ref).norm(dim=-1) / ref.norm(dim=-1)).max())
    print(f"EVA02-L/14-336 B=16 bf16 against fp32: worst row {err:.4g}")
    assert err < 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("backbone", ["ViT-B/16", "ViT-L/14"])
def test_cuda_vit_runs_only_k2s_kernels(cuda_device, backbone):
    """OpenAI's ViTs launch K2's kernels alone, as many as before the EVA02
    kernels were added (2 LayerNorms, 4 GEMMs, 1 attention a block), none
    of the EVA02 modes; and the features are bit for bit a chain written
    out of the same kernels with K2's epilogues."""
    from protoclip_tpu_torch.models import clip

    cfg, params = clip.load_clip(backbone, device=cuda_device, int8=False)
    g = torch.Generator(device=cuda_device).manual_seed(6)
    n_px, layers = cfg.image_resolution, cfg.vision_layers
    images = torch.randn(4, n_px, n_px, 3, device=cuda_device, generator=g).to(torch.bfloat16)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        got = clip.encode_image(params, images, cfg)
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    assert launched == {"layernorm_rows": 2 * layers, "gemm_bias_epilogue": 4 * layers,
                        "attention_packed": layers, "fused_transformer_block": layers}
    from protoclip_tpu_torch.models.vit import patchify
    from protoclip_tpu_torch.ops.layernorm import layer_norm

    vis = params["visual"]
    with torch.inference_mode():
        x = patchify(images, cfg.vision_patch_size) @ vis["patch_embed"]
        cls = vis["class_embedding"].expand(x.shape[0], 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1) + vis["positional_embedding"]
        x = layer_norm(x, vis["ln_pre"]["scale"], vis["ln_pre"]["bias"])
        d, h = x.shape[-1], cfg.vision_heads
        for blk in vis["blocks"]:
            p = kernels._block_args(blk, x.dtype)
            qkv = kernels.gemm_bias_epilogue(kernels.layernorm_rows(x, p["ln1s"], p["ln1b"]),
                                             p["wqkv"], p["bqkv"], "bias")
            a = kernels.attention_packed(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], h)
            x = kernels.gemm_bias_epilogue(a, p["wo"], p["bo"], "bias_residual", x)
            m = kernels.gemm_bias_epilogue(kernels.layernorm_rows(x, p["ln2s"], p["ln2b"]),
                                           p["wfc"], p["bfc"], "bias_gelu")
            x = kernels.gemm_bias_epilogue(m, p["wproj"], p["bproj"], "bias_residual", x)
        want = layer_norm(x[:, 0], vis["ln_post"]["scale"], vis["ln_post"]["bias"]) @ vis["proj"]
    assert torch.equal(got, want)


# -- EVA02-CLIP-bigE's post-norm block ------------------------------------------------------------

BIGE_ROWS = 1024 * 257  # the bank's batch of 1024 images of 257 tokens


def _timed(name, fn, n_bytes, ops):
    """``fn``'s device ms against its bound (``_card.bound_ms``), printed."""
    ms = _card.device_ms(fn)
    bound, by, _, _ = _card.bound_ms(n_bytes, ops)
    print(f"{name}: {ms:.3f} ms, bound {bound:.3f} ms ({by}), {100 * bound / ms:.1f}% of it")


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("rows,d", [(BIGE_ROWS, 1792), (37, 8), (33, 200), (17, 4104),
                                    (5, 30000)])
def test_cuda_layernorm_residual_rows_matches_plain(cuda_device, dtype, rows, d):
    """``layernorm_residual_rows`` (T(x + T(LN(a)))) at the bigE bank's rows
    (1024 x 257 of 1792) and at other widths (30,000: one row a block, over
    48 KB of shared memory) against its plain version: in bf16 by the EVA02
    rule, refusing the LayerNorm left unrounded before the sum; in fp32 at
    the fp32 bars, refusing the pre-norm LN(x + a).  At the bank's rows,
    timed against its bound: a and x read once, out written once."""
    g = torch.Generator(device=cuda_device).manual_seed(d)
    a = (4 * torch.randn(rows, d, device=cuda_device, generator=g)).to(dtype)
    x = torch.randn(rows, d, device=cuda_device, generator=g).to(dtype)
    scale = 1 + 0.1 * torch.randn(d, device=cuda_device, generator=g)
    bias = 0.1 * torch.randn(d, device=cuda_device, generator=g)
    kernels.reset_launch_counts()
    out = kernels.layernorm_residual_rows(a, x, scale, bias)
    want = kernels.layernorm_residual_rows_plain(a, x, scale, bias)
    if dtype == torch.bfloat16:
        unrounded = (x.float() + kernels._layernorm_f32(a, scale, bias, kernels.EVA_LN_EPS))
        _hold_refusing(out, want, unrounded.to(dtype))
    else:
        _hold_refusing(out, want, kernels.layernorm_rows_plain(x + a, scale, bias,
                                                               kernels.EVA_LN_EPS), _bars(dtype))
    assert {k: v for k, v in kernels.launch_counts().items() if v} == {
        "layernorm_residual_rows": 1}
    if rows == BIGE_ROWS:
        vb = a.element_size()
        _timed(f"layernorm_residual_rows ({rows}, {d}) {dtype}",
               lambda: kernels.layernorm_residual_rows(a, x, scale, bias),
               3 * rows * d * vb + 2 * d * 4, 10 * rows * d)


@pytest.mark.cuda
def test_cuda_attention_at_head_width_112_matches_plain(cuda_device):
    """bigE's attention: 16 heads of 112 at L = 257 (a tile's two 64-column
    TMA boxes, the second zero-filled past column 112), in its three modes
    and with lengths below L, against its plain version at the K2 bars; then
    timed at the bank's batch of 1024 against its bound (q, k, v read and o
    written once; 4 L^2 d flops)."""
    B, L, H, dh = 32, 257, 16, 112
    d = H * dh
    g = torch.Generator(device=cuda_device).manual_seed(112)
    qkv = torch.randn(B, L, 3 * d, device=cuda_device, generator=g).to(torch.bfloat16)
    sl = (qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:])
    for length in (L, L - 5, L - 70):
        for mode in ("softmax", "q_round", "no_softmax"):
            _hold(kernels.attention_packed(*sl, H, False, length, mode),
                  kernels.fused_attention_packed_plain(*sl, H, False, length, mode),
                  _bars(torch.bfloat16))
    qkv = torch.randn(1024, L, 3 * d, device=cuda_device, generator=g).to(torch.bfloat16)
    sl = (qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:])
    _hold(kernels.attention_packed(*sl, H)[:8],
          kernels.fused_attention_packed_plain(*(t[:8] for t in sl), H), _bars(torch.bfloat16))
    _timed("attention_packed (1024, 257, 16 x 112)", lambda: kernels.attention_packed(*sl, H),
           4 * BIGE_ROWS * d * 2, _card.attention_flops(1024, L, d, False))


def _postnorm_reference():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "eva_postnorm_reference", Path(__file__).with_name("eva_postnorm_reference.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.cuda
def test_cuda_bige_block_and_its_gemms_match_plain(cuda_device):
    """One bigE post-norm block at its published widths (1792, 16 heads of
    112, MLP 15360; L = 257), converted from a seeded state dict in
    EVA-CLIP's layout, at B = 16 against its plain version at the card's
    bf16 bars, in 7 launches; bf16 alone on the card (fp32 raises).  Then
    its GEMMs at the bank's 1024 x 257 rows (1792 -> 5376, 1792 -> 1792,
    1792 -> 15360 with the exact GELU, 15360 -> 1792) against their plain
    versions on the first and last 2048 rows, each and the block timed
    against its bound."""
    import dataclasses

    from protoclip_tpu_torch.models import clip, eva

    ref = _postnorm_reference()
    t = dict(ref.TINY, width=1792, heads=16, layers=1, hidden=15360, text_layers=0)
    sd = {k: v for k, v in ref.postnorm_state_dict(7, t).items() if k.startswith("visual.")}
    cfg = dataclasses.replace(clip.PORT_BACKBONE_CONFIGS["EVA02-CLIP-bigE-14-plus"],
                              vision_layers=1, image_resolution=56)
    bf16 = torch.bfloat16
    blk = eva.postnorm_visual_from_state_dict(sd, cfg, bf16, cuda_device)["blocks"][0]
    g = torch.Generator(device=cuda_device).manual_seed(8)
    x = torch.randn(16, 257, 1792, device=cuda_device, generator=g).to(bf16)
    kernels.reset_launch_counts()
    _hold(kernels.fused_eva_postnorm_block(x, blk, 16),
          kernels.fused_eva_postnorm_block_plain(x, blk, 16), _bars(bf16))
    assert {k: v for k, v in kernels.launch_counts().items() if v} == {
        "gemm_bias_epilogue": 4, "gemm_bias_epilogue.bias_gelu_erf": 1, "attention_packed": 1,
        "layernorm_residual_rows": 2, "fused_eva_postnorm_block": 1}
    with pytest.raises(TypeError, match="bfloat16"):
        kernels.fused_eva_postnorm_block(x.float(), blk, 16)
    m, d, hid = 16 * 257, 1792, 15360
    _timed("fused_eva_postnorm_block B=16", lambda: kernels.fused_eva_postnorm_block(x, blk, 16),
           (2 * m * d + 4 * d * d + 2 * d * hid + 4 * d + hid) * 2 + 4 * d * 4,
           8 * m * d * d + 4 * m * d * hid + _card.attention_flops(16, 257, d, False))
    at, mlp = blk["attn"], blk["mlp"]
    a = torch.randn(BIGE_ROWS, d, device=cuda_device, generator=g).to(bf16)
    ends = torch.cat([torch.arange(2048), torch.arange(BIGE_ROWS - 2048, BIGE_ROWS)])
    for name, w, b, epi, src in (("qkv 1792 -> 5376", at["wqkv"], at["bqkv"], "bias", a),
                                 ("out 1792 -> 1792", at["wo"], at["bo"], "bias", a),
                                 ("fc 1792 -> 15360", mlp["w_fc"], mlp["b_fc"], "bias_gelu_erf",
                                  a)):
        out = kernels.gemm_bias_epilogue(src, w, b, epi)
        _hold(out[ends], kernels.gemm_bias_epilogue_plain(src[ends], w, b, epi), _bars(bf16))
        kk, nn = w.shape
        _timed(f"gemm_bias_epilogue {name} ({BIGE_ROWS} rows)",
               lambda: kernels.gemm_bias_epilogue(src, w, b, epi),
               (BIGE_ROWS * kk + kk * nn + nn + BIGE_ROWS * nn) * 2, 2 * BIGE_ROWS * kk * nn)
    h = out
    del a
    out = kernels.gemm_bias_epilogue(h, mlp["w_proj"], mlp["b_proj"], "bias")
    _hold(out[ends], kernels.gemm_bias_epilogue_plain(h[ends], mlp["w_proj"], mlp["b_proj"],
                                                      "bias"), _bars(bf16))
    _timed(f"gemm_bias_epilogue proj 15360 -> 1792 ({BIGE_ROWS} rows)",
           lambda: kernels.gemm_bias_epilogue(h, mlp["w_proj"], mlp["b_proj"], "bias"),
           (BIGE_ROWS * hid + hid * d + d + BIGE_ROWS * d) * 2, 2 * BIGE_ROWS * hid * d)
