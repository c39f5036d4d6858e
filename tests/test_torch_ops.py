"""protoclip_tpu_torch.ops against protoclip_tpu.ops, on the CPU.

The same numpy inputs go through the JAX function (XLA on the CPU, or the
Pallas kernel in interpret mode) and through the port's counterpart; on
the CPU every kernel wrapper of the port runs its plain PyTorch version.
The CUDA kernels themselves are held to those plain versions on the card
by tests/test_torch_cuda.py.
"""

import gzip
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protoclip_tpu.models.layers import init_block_params as jax_init_block_params
from protoclip_tpu.models.layers import residual_block as jax_residual_block
from protoclip_tpu.ops import attention as jattn
from protoclip_tpu.ops import proto as jproto
from protoclip_tpu.ops.activations import quick_gelu as jax_quick_gelu
from protoclip_tpu.ops.layernorm import layer_norm as jax_layer_norm
from protoclip_tpu.ops.pallas_kernels import fused_attention_packed as jax_fused_attention_packed
from protoclip_tpu.ops.pallas_kernels import fused_attention as jax_fused_attention
from protoclip_tpu.ops.pallas_kernels import _block_kernel
from protoclip_tpu.ops.pallas_kernels import fused_transformer_block as jax_fused_block

from protoclip_tpu_torch.models.clip import _blocks_from_jax
from protoclip_tpu_torch.ops import _build, attention, kernels, proto
from protoclip_tpu_torch.ops.activations import quick_gelu
from protoclip_tpu_torch.ops.layernorm import layer_norm


def T(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def np32(t):
    return t.detach().float().numpy()


def jax_block(D, seed=0):
    """One JAX block (fp32) with non-trivial LN and biases, and the port's
    copy of it (un-stacked, fused ``wqkv``)."""
    stacked = jax_init_block_params(jax.random.PRNGKey(seed), 1, D)
    stacked = jax.tree_util.tree_map(np.asarray, stacked)
    rng = np.random.default_rng(seed + 1)
    for grp in ("ln_1", "ln_2"):
        stacked[grp]["scale"] = (1 + 0.1 * rng.standard_normal((1, D))).astype(np.float32)
        stacked[grp]["bias"] = (0.1 * rng.standard_normal((1, D))).astype(np.float32)
    for grp, key, n in (("attn", "bq", D), ("attn", "bk", D), ("attn", "bv", D),
                        ("attn", "bo", D), ("mlp", "b_fc", 4 * D), ("mlp", "b_proj", D)):
        stacked[grp][key] = (0.02 * rng.standard_normal((1, n))).astype(np.float32)
    jblk = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), stacked)
    return jblk, _blocks_from_jax(stacked)[0]


def cast_block(block, dtype):
    """The port block in ``dtype`` with LN params in fp32."""
    out = {}
    for grp, sub in block.items():
        out[grp] = {k: (v.float() if grp.startswith("ln") else v.to(dtype)) for k, v in sub.items()}
    return out


# -- elementwise, LayerNorm, attention ------------------------------------------


@pytest.mark.parametrize("shape,norm_shape", [((3, 7, 64), (64,)), ((2, 4, 5, 5), (4, 5, 5))])
def test_layer_norm_matches_jax(rng, shape, norm_shape):
    x = rng.standard_normal(shape).astype(np.float32) * 3 + 1
    s = rng.standard_normal(norm_shape).astype(np.float32)
    b = rng.standard_normal(norm_shape).astype(np.float32)
    ours = np32(layer_norm(T(x), T(s), T(b)))
    ref = np.asarray(jax_layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_layer_norm_keeps_dtype(rng):
    x = T(rng.standard_normal((4, 32)), torch.bfloat16)
    out = layer_norm(x, torch.ones(32), torch.zeros(32))
    assert out.dtype == torch.bfloat16


def test_quick_gelu_matches_jax(rng):
    x = rng.standard_normal((5, 33)).astype(np.float32) * 4
    np.testing.assert_allclose(
        np32(quick_gelu(T(x))), np.asarray(jax_quick_gelu(jnp.asarray(x))), atol=1e-5
    )


@pytest.mark.parametrize("masked", [False, True])
def test_attention_core_matches_jax(rng, masked):
    B, H, L, dh = 2, 3, 13, 16
    q, k, v = (rng.standard_normal((B, H, L, dh)).astype(np.float32) for _ in range(3))
    mask = np.triu(np.full((L, L), -np.inf, np.float32), 1) if masked else None
    ours = attention.attention_core(T(q), T(k), T(v), None if mask is None else T(mask))
    ref = jattn.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(np32(ours), np.asarray(ref), atol=1e-5)


def test_causal_mask_matches_jax():
    np.testing.assert_array_equal(
        np32(attention._causal_mask(6)), np.asarray(jattn._causal_mask(6))
    )


@pytest.mark.parametrize("causal,explicit_mask", [(False, False), (True, False), (True, True)])
def test_multi_head_attention_matches_jax(rng, causal, explicit_mask):
    B, L, D, H = 2, 13, 64, 4
    jblk, blk = jax_block(D)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    mask = None
    if explicit_mask:  # key padding of the last 3 positions
        mask = np.zeros((L, L), np.float32)
        mask[:, -3:] = -np.inf
    ours = attention.multi_head_attention(
        T(x), blk["attn"], H, None if mask is None else T(mask), causal=causal
    )
    ref = jattn.multi_head_attention(
        jnp.asarray(x), jblk["attn"], H, None if mask is None else jnp.asarray(mask),
        causal=causal,
    )
    np.testing.assert_allclose(np32(ours), np.asarray(ref), atol=1e-5)


def test_cross_attention_single_query_matches_jax(rng):
    B, L, D, H, out = 2, 9, 32, 4, 16
    p = {k: rng.standard_normal((D, D)).astype(np.float32) * 0.1 for k in ("wq", "wk", "wv")}
    p["wo"] = rng.standard_normal((D, out)).astype(np.float32) * 0.1
    p.update({k: rng.standard_normal(D).astype(np.float32) for k in ("bq", "bk", "bv")})
    p["bo"] = rng.standard_normal(out).astype(np.float32)
    q_tok = rng.standard_normal((B, D)).astype(np.float32)
    kv = rng.standard_normal((B, L, D)).astype(np.float32)
    ours = attention.cross_attention_single_query(T(q_tok), T(kv), {k: T(v) for k, v in p.items()}, H)
    ref = jattn.cross_attention_single_query(
        jnp.asarray(q_tok), jnp.asarray(kv), {k: jnp.asarray(v) for k, v in p.items()}, H
    )
    np.testing.assert_allclose(np32(ours), np.asarray(ref), atol=1e-5)


# -- prototype math ------------------------------------------------------------------


def test_proto_ops_match_jax(rng):
    N, K, d, Q = 5, 3, 16, 7
    bank = rng.standard_normal((N * K, d)).astype(np.float32)
    q = rng.standard_normal((Q, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    txt = rng.standard_normal((N, d)).astype(np.float32)

    img_p = proto.class_prototypes(T(bank), N, K)
    j_img_p = jproto.class_prototypes(jnp.asarray(bank), N, K)
    np.testing.assert_allclose(np32(img_p), np.asarray(j_img_p), atol=1e-5)
    txt_p = proto.l2_normalize(T(txt))
    j_txt_p = jproto.l2_normalize(jnp.asarray(txt))
    np.testing.assert_allclose(np32(txt_p), np.asarray(j_txt_p), atol=1e-5)

    np.testing.assert_allclose(
        np32(proto.squared_euclidean(T(q), img_p)),
        np.asarray(jproto.squared_euclidean(jnp.asarray(q), j_img_p)), atol=1e-5,
    )
    np.testing.assert_allclose(
        np32(proto.proto_logits(T(q), img_p)),
        np.asarray(jproto.proto_logits(jnp.asarray(q), j_img_p)), atol=1e-5,
    )
    for alpha, beta in ((0.0, 1.0), (0.5, 5.0), (1.0, 20.0)):
        ours = proto.proto_probs(T(q), img_p, txt_p, alpha, beta)
        ref = jproto.proto_probs(jnp.asarray(q), j_img_p, j_txt_p, alpha, beta)
        np.testing.assert_allclose(np32(ours), np.asarray(ref), atol=1e-5)
    labels, conf = proto.proto_predict(T(q), img_p, txt_p, 0.5, 5.0)
    j_labels, j_conf = jproto.proto_predict(jnp.asarray(q), j_img_p, j_txt_p, 0.5, 5.0)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(j_labels))
    np.testing.assert_allclose(np32(conf), np.asarray(j_conf), atol=1e-5)


def test_class_prototypes_zero_bank_is_finite():
    out = proto.class_prototypes(torch.zeros(6, 4), 3, 2)
    assert torch.isfinite(out).all() and float(out.abs().max()) == 0.0


# -- K1 and K2 plain versions against the Pallas kernels (interpret mode) ----------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,causal", [(50, False), (77, True), (197, False)])
def test_fused_attention_packed_plain_matches_pallas(rng, L, causal, dtype):
    B, H, D = 2, 4, 128
    q, k, v = (rng.standard_normal((B, L, D)).astype(np.float32) for _ in range(3))
    jd = jnp.dtype(dtype)
    ref = np.asarray(jax_fused_attention_packed(
        *(jnp.asarray(t, jd) for t in (q, k, v)), H, causal=causal, interpret=True
    ).astype(jnp.float32))
    tdtype = getattr(torch, dtype)
    ours = np32(kernels.fused_attention_packed(*(T(t, tdtype) for t in (q, k, v)), H, causal))
    # the bars of tests/test_pallas.py:69-72
    np.testing.assert_allclose(ours, ref, atol=2e-2)
    assert np.abs(ours - ref).mean() < 1e-3


@pytest.mark.parametrize("L,causal", [(8, False), (50, False), (77, False), (197, False),
                                      (5, True), (77, True)])
def test_fused_attention_plain_matches_pallas(rng, L, causal):
    """K4's plain version against the head-major Pallas kernel in
    interpret mode, at the shapes and bar of tests/test_pallas.py:12-36."""
    B, H, dh = (1, 2, 64) if causal else (2, 3, 64)
    q, k, v = (rng.standard_normal((B, H, L, dh)).astype(np.float32) for _ in range(3))
    ref = np.asarray(jax_fused_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                         interpret=True))
    ours = np32(kernels.fused_attention(*map(T, (q, k, v)), causal))
    np.testing.assert_allclose(ours, ref, atol=2e-5)


def test_fused_attention_plain_bf16_matches_pallas(rng):
    """bf16 at the bar of tests/test_pallas.py:39-46."""
    B, H, L, dh = 2, 2, 77, 64
    q, k, v = (rng.standard_normal((B, H, L, dh)).astype(np.float32) for _ in range(3))
    ref = np.asarray(jax_fused_attention(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
                                         interpret=True).astype(jnp.float32))
    ours = np32(kernels.fused_attention(*(T(t, torch.bfloat16) for t in (q, k, v))))
    np.testing.assert_allclose(ours, ref, atol=0.05)


def test_fused_attention_plain_is_the_packed_plain_per_head(rng):
    """K1's plain version is K4's on the head-major view of each tensor."""
    B, L, D, H = 2, 13, 64, 4
    q, k, v = (T(rng.standard_normal((B, L, D))) for _ in range(3))
    heads = [t.reshape(B, L, H, D // H).transpose(1, 2) for t in (q, k, v)]
    packed = kernels.fused_attention_packed_plain(q, k, v, H, True, 9)
    head_major = kernels.fused_attention_plain(*heads, True, 9)
    assert torch.equal(packed, head_major.transpose(1, 2).reshape(B, L, D))


@pytest.mark.parametrize("L,causal", [(50, False), (13, True)])
def test_fused_block_plain_fp32_matches_pallas_and_residual_block(rng, L, causal):
    B, D, H = 4, 128, 4
    jblk, blk = jax_block(D)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    ours = np32(kernels.fused_transformer_block_plain(T(x), blk, H, causal))
    pallas = np.asarray(jax_fused_block(jnp.asarray(x), jblk, H, causal=causal, interpret=True))
    xla = np.asarray(jax_residual_block(jnp.asarray(x), jblk, H, causal=causal))
    # the JAX package's own bar (tests/test_pallas.py:90)
    np.testing.assert_allclose(ours, pallas, atol=5e-4)
    np.testing.assert_allclose(ours, xla, atol=5e-4)


class _Ref:
    """A stand-in for a Pallas ref, so the kernel body runs as plain jnp."""

    def __init__(self, value=None):
        self.value = value

    def __getitem__(self, idx):
        return self.value

    def __setitem__(self, idx, value):
        self.value = value


def _block_kernel_op_by_op(x, jblk, n_head, causal):
    """The TPU kernel's body (``_block_kernel``) run eagerly, one jnp op at
    a time, on the operands its wrapper builds: every ``.astype`` is a
    rounding, as in the kernel's definition."""
    dtype = x.dtype
    attn, mlp = jblk["attn"], jblk["mlp"]
    args = (
        jnp.concatenate([attn["wq"], attn["wk"], attn["wv"]], axis=1).astype(dtype),
        jnp.concatenate([attn["bq"], attn["bk"], attn["bv"]]).astype(dtype),
        attn["wo"].astype(dtype), attn["bo"].astype(dtype),
        jblk["ln_1"]["scale"], jblk["ln_1"]["bias"], jblk["ln_2"]["scale"], jblk["ln_2"]["bias"],
        mlp["w_fc"].astype(dtype), mlp["b_fc"].astype(dtype),
        mlp["w_proj"].astype(dtype), mlp["b_proj"].astype(dtype),
    )
    out = _Ref()
    with jax.disable_jit():
        _block_kernel(_Ref(x), *map(_Ref, args), out,
                      n_head=n_head, length=x.shape[1], causal=causal)
    return out.value


@pytest.mark.parametrize("L,causal", [(50, False), (13, True)])
def test_fused_block_plain_bf16_matches_tpu_kernel(rng, L, causal):
    """bf16 with the same cast points on both sides.

    Held to the bars of tests/test_pallas.py:71-72 against the kernel body
    run op by op.  The compiled interpret-mode call fuses across the bf16
    casts on the CPU (XLA keeps the excess fp32 precision), so against it
    about half the outputs differ by an ulp or more; it is held to the
    card's bars instead: max|diff| / max|ref| < 1e-2, cosine > 0.9999.
    """
    B, D, H = 4, 128, 4
    jblk, blk = jax_block(D)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    ours = np32(kernels.fused_transformer_block_plain(
        T(x, torch.bfloat16), cast_block(blk, torch.bfloat16), H, causal
    ))
    op_by_op = np.asarray(_block_kernel_op_by_op(xb, jblk, H, causal).astype(jnp.float32))
    np.testing.assert_allclose(ours, op_by_op, atol=2e-2)
    assert np.abs(ours - op_by_op).mean() < 1e-3

    jb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jblk)
    pallas = np.asarray(jax_fused_block(xb, jb, H, causal=causal, interpret=True)
                        .astype(jnp.float32))
    assert np.abs(ours - pallas).max() / np.abs(pallas).max() < 1e-2
    cos = float(ours.ravel() @ pallas.ravel()
                / (np.linalg.norm(ours) * np.linalg.norm(pallas)))
    assert cos > 0.9999


@pytest.mark.parametrize("causal", [False, True])
def test_fused_block_length_contract_matches_pallas(rng, causal):
    """length= path: the caller pre-pads, keys past ``length`` are masked,
    and the output keeps the padded shape (tests/test_pallas.py:156-176)."""
    B, L, D, H, lp = 2, 13, 128, 4, 16
    jblk, blk = jax_block(D)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    xp = np.pad(x, [(0, 0), (0, lp - L), (0, 0)])
    ours = np32(kernels.fused_transformer_block(T(xp), blk, H, causal, length=L))
    assert ours.shape == (B, lp, D)
    pallas = np.asarray(jax_fused_block(
        jnp.asarray(xp), jblk, H, causal=causal, length=L, interpret=True
    ))
    np.testing.assert_allclose(ours, pallas, atol=5e-4)
    ref = np.asarray(jax_residual_block(jnp.asarray(x), jblk, H, causal=causal))
    np.testing.assert_allclose(ours[:, :L], ref, atol=5e-4)


def test_plain_fc_epilogue_differs_from_residual_block_mlp(rng):
    """The kernel's fc bias and QuickGELU run in fp32, layers.mlp in the
    activation dtype: in bf16 the two are not the same function."""
    from protoclip_tpu_torch.models.layers import residual_block

    B, L, D, H = 2, 13, 64, 4
    _, blk = jax_block(D)
    bblk = cast_block(blk, torch.bfloat16)
    x = T(rng.standard_normal((B, L, D)), torch.bfloat16)
    plain = kernels.fused_transformer_block_plain(x, bblk, H)
    assert not torch.equal(plain, residual_block(x, bblk, H))
    np.testing.assert_allclose(np32(plain), np32(residual_block(x, bblk, H)), atol=0.1)


# -- the wrappers on the CPU ---------------------------------------------------------


def test_wrappers_take_plain_versions_on_cpu(rng):
    B, L, D, H = 2, 11, 64, 4
    _, blk = jax_block(D)
    x = T(rng.standard_normal((B, L, D)))
    kernels.reset_launch_counts()
    s, b = blk["ln_1"]["scale"], blk["ln_1"]["bias"]
    assert torch.equal(kernels.layernorm_rows(x, s, b), kernels.layernorm_rows_plain(x, s, b))
    w, bias = blk["attn"]["wo"], blk["attn"]["bo"]
    for epi, res in (("bias", None), ("bias_residual", x), ("bias_gelu", None)):
        assert torch.equal(kernels.gemm_bias_epilogue(x, w, bias, epi, residual=res),
                           kernels.gemm_bias_epilogue_plain(x, w, bias, epi, residual=res))
    assert torch.equal(kernels.attention_packed(x, x, x, H, True, 7),
                       kernels.fused_attention_packed_plain(x, x, x, H, True, 7))
    assert torch.equal(kernels.fused_attention_packed(x, x, x, H),
                       kernels.fused_attention_packed_plain(x, x, x, H))
    xh = x.reshape(B, L, H, D // H).transpose(1, 2).contiguous()
    assert torch.equal(kernels.fused_attention(xh, xh, xh, True),
                       kernels.fused_attention_plain(xh, xh, xh, True))
    assert torch.equal(kernels.fused_transformer_block(x, blk, H, True),
                       kernels.fused_transformer_block_plain(x, blk, H, True))
    # no kernel was launched
    assert set(kernels.launch_counts().values()) == {0}


def test_wrappers_reject_bad_arguments(rng):
    x = T(rng.standard_normal((2, 5, 64)))
    w, b = torch.zeros(64, 64), torch.zeros(64)
    with pytest.raises(ValueError, match="unknown epilogue"):
        kernels.gemm_bias_epilogue(x, w, b, "bias_relu")
    with pytest.raises(ValueError, match="residual"):
        kernels.gemm_bias_epilogue(x, w, b, "bias_residual")
    with pytest.raises(ValueError, match="must divide"):
        kernels.fused_transformer_block(x, {}, 5)
    with pytest.raises(ValueError, match="length"):
        kernels.fused_transformer_block(x, {}, 4, length=9)


@pytest.mark.parametrize("sizes,offset,match", [
    ({"K": 768, "N": 2304}, 0, None),
    ({"K": 200, "N": 192}, 0, None),
    ({"K": 100, "N": 192}, 0, "K=100 is not a multiple of 8"),
    ({"dh": 64, "row stride": 2308}, 0, "row stride=2308"),
    ({"dh": 64}, 1, "does not start on a 16-byte boundary"),
    ({"dh": 64}, 8, None),
])
def test_piece_rule_is_a_function_of_sizes_and_addresses(sizes, offset, match):
    """The bf16 GEMM (TMA) and attention (cp.async) move 16-byte pieces: the
    wrappers admit sizes and strides in multiples of 8 elements and tensors
    on 16-byte boundaries, decided on the CPU before any launch."""
    base = torch.zeros(64, dtype=torch.bfloat16)
    assert base.data_ptr() % 16 == 0
    view = base[offset:]
    if match is None:
        kernels.require_pieces("k", sizes, {"a": view})
    else:
        with pytest.raises(ValueError, match=match):
            kernels.require_pieces("k", sizes, {"a": view})


@pytest.mark.parametrize("k,n,offset,match", [
    (768, 2304, 0, None),
    (3072, 768, 0, None),
    (200, 192, 0, "K=200 is not a multiple of 16"),
    (768, 100, 0, "N=100 is not a multiple of 8"),
    (768, 768, 8, "does not start on a 16-byte boundary"),
])
def test_int8_gemm_shape_rule(k, n, offset, match):
    """The s8 wgmma GEMM reads K-byte int8 rows through TMA and writes its
    output in 16-byte pieces: K a multiple of 16, N of 8, every tensor on a
    16-byte boundary, decided on the CPU before any launch."""
    base = torch.zeros(64, dtype=torch.int8)
    assert base.data_ptr() % 16 == 0
    if match is None:
        kernels.require_int8_pieces("k", k, n, {"a_q": base[offset:]})
    else:
        with pytest.raises(ValueError, match=match):
            kernels.require_int8_pieces("k", k, n, {"a_q": base[offset:]})


@pytest.mark.parametrize("w,offset,match", [
    (8, 0, None),
    (768, 0, None),
    (4096, 0, None),
    (100, 0, "W=100 is not a multiple of 8"),
    (4104, 0, "row width 4104 is not in"),
    (768, 4, "does not start on a 16-byte boundary"),
])
def test_quant_rows_width_rule(w, offset, match):
    """quant_rows.cu holds a row in registers, read in 16-byte pieces: W a
    multiple of 8 up to 4096 and the input on a 16-byte boundary."""
    base = torch.zeros(64, dtype=torch.bfloat16)
    if match is None:
        kernels.require_quant_width("q", w, {"x": base[offset:]})
    else:
        with pytest.raises(ValueError, match=match):
            kernels.require_quant_width("q", w, {"x": base[offset:]})


def test_chip_smoke_reads_ptxas_usage_of_the_tensor_core_kernels():
    """chip_smoke.py's build line reports registers and spills per template
    instantiation of the tensor-core kernels and of the fp32 GEMM and
    attention, from nvcc's -Xptxas -v; other kernels are left out."""
    import chip_smoke

    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN52_GLOBAL__N__7efae599_19_attention_"
        "packed_cu_b6d57c5320attention_bf16_wgmmaILi64ELi1EEEv14CUtensorMap_stS0_S0_"
        "P13__nv_bfloat16xxxiiiiiif' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN52_attention_bf16_wgmma",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN54_GLOBAL__N__659883fd_21_gemm_bias_"
        "epilogue_cu_a59d695715gemm_bf16_wgmmaILin1EEEv14CUtensorMap_st' for 'sm_90a'",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 90 registers, used 2 barriers, 48 bytes smem",
        "ptxas info    : Compiling entry function '_ZN54_gemm_f32_simtILi4EEEv' for 'sm_90a'",
        "ptxas info    : Used 70 registers, used 1 barriers, 8704 bytes smem",
        "ptxas info    : Compiling entry function '_ZN54_GLOBAL__N__659883fd_21_gemm_bias_"
        "epilogue_cu_a59d695713gemm_f32_ringILin1EEEv14CUtensorMap_stS0_PKfS2_Pfiiiii' "
        "for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 64 bytes smem",
        "ptxas info    : Compiling entry function '_ZN52_GLOBAL__N__7efae599_19_attention_"
        "packed_cu_b6d57c5319attention_f32_tiledILi128EEEvPKfS1_S1_xxxPfxxxiiiiiif' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 96 registers, used 1 barriers",
        # the s8 GEMM is templated on its activation type, then its epilogue
        "ptxas info    : Compiling entry function '_ZN54_GLOBAL__N__0c3e5b7a_21_gemm_int8_"
        "epilogue_cu_9f1e2d3a13gemm_s8_wgmmaI13__nv_bfloat16Li1EEEv14CUtensorMap_stS1_PKfS3_S3_"
        "PKT_PS4_iiii' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 104 registers, used 2 barriers",
        "ptxas info    : Compiling entry function '_ZN54_GLOBAL__N__0c3e5b7a_21_gemm_int8_"
        "epilogue_cu_9f1e2d3a13gemm_s8_wgmmaIfLi2EEEv14CUtensorMap_stS1_PKfS3_S3_PKT_PfS4_iiii' "
        "for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 98 registers, used 2 barriers",
    ])
    assert chip_smoke.ptxas_usage(log) == {
        "attention_bf16_wgmma<64,1>": {"registers": 128, "spill_bytes": 0},
        "gemm_bf16_wgmma<-1>": {"registers": 90, "spill_bytes": 4},
        "gemm_f32_ring<-1>": {"registers": 168, "spill_bytes": 0},
        "attention_f32_tiled<128>": {"registers": 96, "spill_bytes": 0},
        "gemm_s8_wgmma<__nv_bfloat16,1>": {"registers": 104, "spill_bytes": 0},
        "gemm_s8_wgmma<float,2>": {"registers": 98, "spill_bytes": 0},
    }


def test_sources_hash_tracks_every_source(tmp_path, monkeypatch):
    """The library is rebuilt when any .cu or .cuh changes."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    before = _build.sources_hash()
    assert {p.suffix for p in csrc.iterdir()} == {".cu", ".cuh"}
    for path in sorted(csrc.iterdir()):
        text = path.read_text()
        path.write_text(text + "\n// touched\n")
        assert _build.sources_hash() != before, path.name
        path.write_text(text)
    assert _build.sources_hash() == before


# -- tokenizer copy --------------------------------------------------------------------


def _tiny_vocab(path):
    """A merge table of a handful of rules (the real one is model data and
    not in the repository)."""
    merges = ["h e", "l l", "he ll", "o</w>", "hell o</w>", "w o", "r l", "wo rl", "d</w>"]
    with gzip.open(path, "wt", encoding="utf-8") as fh:
        fh.write("#version: test\n" + "\n".join(merges) + "\n")


def test_tokenizer_copy_round_trip_and_matches_jax(tmp_path):
    from protoclip_tpu.tokenizer.bpe import ClipTokenizer as JaxTokenizer
    from protoclip_tpu.tokenizer.bpe import tokenize as jax_tokenize
    from protoclip_tpu_torch.tokenizer import EOT_ID, SOT_ID, ClipTokenizer, tokenize
    from protoclip_tpu_torch.tokenizer.bpe import VOCAB_SIZE

    assert (SOT_ID, EOT_ID) == (49406, 49407) and EOT_ID == VOCAB_SIZE - 1
    vocab = tmp_path / "vocab.txt.gz"
    _tiny_vocab(vocab)
    ours, theirs = ClipTokenizer(str(vocab)), JaxTokenizer(str(vocab))
    for text in ("Hello world", "a photo of a sea lion.", "héllo, wörld!! 42"):
        ids = ours.encode(text)
        assert ids == theirs.encode(text)
        assert ours.decode(ids) == theirs.decode(ids)
    assert ours.decode(ours.encode("Hello   World")) == "hello world "
    texts = ["hello world", "art of the dog."]
    np.testing.assert_array_equal(
        tokenize(texts, context_length=24, tokenizer=ours),
        jax_tokenize(texts, context_length=24, tokenizer=theirs),
    )


def test_tokenizer_without_vocab_raises(tmp_path, monkeypatch):
    from protoclip_tpu_torch.tokenizer import default_vocab_path

    monkeypatch.setenv("PROTOCLIP_BPE_PATH", str(tmp_path / "missing.txt.gz"))
    with pytest.raises(FileNotFoundError):
        default_vocab_path()
