"""The port's W8A8 serving mode (K3) and its extraction CLI against the JAX
package, on the CPU.

The same numpy inputs go through ``protoclip_tpu`` (the Pallas kernel in
interpret mode, or its body run op by op) and through the port, whose
wrappers run their plain PyTorch versions on the CPU.  The CUDA kernels
are held to those plain versions on the card by tests/test_torch_cuda.py.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protoclip_tpu.models import clip as jclip
from protoclip_tpu.models.layers import init_block_params as jax_init_block_params
from protoclip_tpu.models.layers import residual_block as jax_residual_block
from protoclip_tpu.ops import pallas_kernels as pk

from protoclip_tpu_torch.models import clip
from protoclip_tpu_torch.models import layers as port_layers
from protoclip_tpu_torch.ops import kernels
from tests.test_models import TINY_VIT, _tiny_torch_style_state_dict
from tests.test_torch_models import leaves, np_tree, port_config, tiny_tokens
from tests.test_torch_ops import T, _Ref, jax_block, np32

QBLOCK_ORDER = ("wqkv", "sqkv", "bqkv", "wo", "so", "bo", "ln1s", "ln1b", "ln2s", "ln2b",
                "wfc", "sfc", "bfc", "wproj", "sproj", "bproj")  # _block_kernel_int8's refs
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def jax_qblock(D, seed=0):
    """One JAX layer quantized by ``quantize_stacked_blocks``, the same
    layer quantized by the port's ``quantize_block``, and the fp32 JAX
    block."""
    jblk, blk = jax_block(D, seed)
    stacked = pk.quantize_stacked_blocks(jax.tree_util.tree_map(lambda a: a[None], jblk))
    return jax.tree_util.tree_map(lambda a: a[0], stacked), kernels.quantize_block(blk), jblk


def cosine(a, b):
    a, b = np.ravel(a), np.ravel(b)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def row_cosines(a, b):
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    return np.sum(a * b, axis=-1)


# -- quantizers and the int8 product -------------------------------------------------


def test_quantize_cols_matches_jax(rng):
    w = rng.standard_normal((64, 48)).astype(np.float32)
    w[:, 5] = 0.0  # the 1e-6 floor
    w[:6, 7] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]  # scale exactly 1: exact .5 ties
    w[6:, 7] = 0.0
    q, s = kernels.quantize_cols(torch.from_numpy(w))
    jq, js = pk.quantize_cols(jnp.asarray(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8 and s.shape == (1, 48)
    assert q[:6, 7].tolist() == [127, 0, 2, 2, 0, -2]  # round half to even
    stacked = np.stack([w, 2 * w])  # (L, in, out) stacks quantize per layer
    q2, s2 = kernels.quantize_cols(torch.from_numpy(stacked))
    jq2, js2 = pk.quantize_cols(jnp.asarray(stacked))
    np.testing.assert_array_equal(q2.numpy(), np.asarray(jq2))
    np.testing.assert_array_equal(s2.numpy(), np.asarray(js2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_rows_plain_matches_jax(rng, dtype):
    x = (rng.standard_normal((3, 7, 96)) * 3).astype(np.float32)
    x[0, 2] = 0.0  # the 1e-6 floor
    x[1, 3] = 0.0
    x[1, 3, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]  # exact .5 ties
    jd, td = DTYPES[dtype]
    q, s = kernels.quant_rows_plain(T(x, td))
    jq, js = pk._quant_rows(jnp.asarray(x, jd).reshape(-1, 96))
    np.testing.assert_array_equal(q.reshape(-1, 96).numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.reshape(-1, 1).numpy(), np.asarray(js))
    assert s.shape == (3, 7, 1) and float(s[0, 2, 0]) == np.float32(1e-6) / np.float32(127)
    assert q[1, 3, :6].tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("K", [128, 3072])
def test_int8_matmul_plain_matches_jax(rng, K):
    """Exact: float64 holds every int32 sum; at K=3072 the all-127 row
    reaches 3072 * 127**2 > 2**24, where an fp32 sum would round."""
    x_q = rng.integers(-127, 128, (9, K)).astype(np.int8)
    x_q[0] = 127
    w_q = rng.integers(-127, 128, (K, 40)).astype(np.int8)
    w_q[:, 0] = 127
    x_s = (rng.random((9, 1)) * 0.01).astype(np.float32)
    w_s = (rng.random((1, 40)) * 0.01).astype(np.float32)
    ours = kernels.int8_matmul_plain(*map(torch.from_numpy, (x_q, x_s, w_q, w_s)))
    ref = pk._int8_matmul(*map(jnp.asarray, (x_q, x_s, w_q, w_s)))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_quantize_block_matches_quantize_stacked_blocks():
    jq, q, _ = jax_qblock(64)
    assert sorted(q) == sorted(QBLOCK_ORDER)
    for key in QBLOCK_ORDER:
        ref = np.asarray(jq[key])
        if key[0] == "w":  # stored (out, in): the int8 GEMM kernel's K-major layout
            assert q[key].dtype == torch.int8 and q[key].is_contiguous()
            ref = ref.T
        np.testing.assert_array_equal(q[key].numpy(), ref.reshape(q[key].shape), err_msg=key)


# -- the whole block -----------------------------------------------------------------------


def _jax_body_op_by_op(x, jq, n_head, causal):
    """``_block_kernel_int8`` run eagerly, one jnp op at a time."""
    out = _Ref()
    with jax.disable_jit():
        pk._block_kernel_int8(_Ref(x), *(_Ref(jq[k]) for k in QBLOCK_ORDER), out,
                              n_head=n_head, length=x.shape[1], causal=causal)
    return out.value


def _jax_ln(v, s, b):
    vf = v.astype(jnp.float32)
    mean = jnp.mean(vf, axis=-1, keepdims=True)
    c = vf - mean
    var = jnp.mean(c * c, axis=-1, keepdims=True)
    return c * jax.lax.rsqrt(var + 1e-5) * s + b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,causal", [(50, False), (13, True)])
def test_int8_block_plain_stages_are_the_tpu_body_bit_for_bit(rng, L, causal, dtype):
    """Each step of the plain K3, given the JAX body's own input to that
    step, returns the body's output bit for bit: same cast points, same
    quantizer, same dequantization order.  Two steps are held to a rule
    instead: the LayerNorm statistics sum in another order (PyTorch's and
    XLA's reductions apiece), so the LN-quant codes are equal in >= 99.9%
    of entries and never more than one step apart, with scales within 1e-6
    relative (the card's rule for it); the fp32 QuickGELU hidden may differ
    in an ulp (each side's exp), its int8 codes and scales do not.  The
    attention core is K2's, held to the Pallas kernel in test_torch_ops."""
    B, D, H = 4, 128, 4
    jd, td = DTYPES[dtype]
    jq, q, _ = jax_qblock(D)
    x = jnp.asarray(rng.standard_normal((B, L, D)).astype(np.float32), jd)

    def port(t):
        return torch.from_numpy(np.asarray(jnp.asarray(t).astype(jnp.float32))).to(
            torch.int8 if t.dtype == jnp.int8 else (torch.float32 if t.dtype == jnp.float32 else td))

    def same(ours, ref):
        np.testing.assert_array_equal(np32(ours) if ours.dtype != torch.int8 else ours.numpy(),
                                      np.asarray(jnp.asarray(ref).astype(
                                          jnp.int8 if ref.dtype == jnp.int8 else jnp.float32)))

    with jax.disable_jit():
        h1q, h1s = pk._quant_rows(_jax_ln(x, jq["ln1s"], jq["ln1b"]).reshape(B * L, D))
        t_h1q, t_h1s = kernels.layernorm_quant_rows_plain(port(x), q["ln1s"], q["ln1b"])
        qkv = (pk._int8_matmul(h1q, h1s, jq["wqkv"], jq["sqkv"]) + jq["bqkv"]).astype(jd)
        same(kernels.gemm_int8_epilogue_plain(port(h1q), port(h1s), q["wqkv"], q["sqkv"],
                                              q["bqkv"], "dequant_bias", td), qkv)
        qkv = qkv.reshape(B, L, 3 * D)
        attn = kernels.fused_attention_packed_plain(
            *(port(qkv[..., i * D:(i + 1) * D]) for i in range(3)), H, causal)
        a_q, a_s = pk._quant_rows(jnp.asarray(np32(attn), jd).reshape(B * L, D))
        t_aq, t_as = kernels.quant_rows_plain(attn)
        same(t_aq.reshape(B * L, D), a_q)
        same(t_as.reshape(B * L, 1), a_s)
        x1 = x + (pk._int8_matmul(a_q, a_s, jq["wo"], jq["so"]) + jq["bo"]).astype(jd).reshape(B, L, D)
        same(kernels.gemm_int8_epilogue_plain(port(a_q), port(a_s), q["wo"], q["so"], q["bo"],
                                              "dequant_bias_residual", td,
                                              residual=port(x).reshape(B * L, D)),
             x1.reshape(B * L, D))
        h2q, h2s = pk._quant_rows(_jax_ln(x1, jq["ln2s"], jq["ln2b"]).reshape(B * L, D))
        t_h2q, t_h2s = kernels.layernorm_quant_rows_plain(port(x1), q["ln2s"], q["ln2b"])
        hid = pk._int8_matmul(h2q, h2s, jq["wfc"], jq["sfc"]) + jq["bfc"]
        hid = hid * jax.nn.sigmoid(1.702 * hid)
        t_hid = kernels.gemm_int8_epilogue_plain(port(h2q), port(h2s), q["wfc"], q["sfc"],
                                                 q["bfc"], "dequant_bias_gelu", td)
        np.testing.assert_allclose(np32(t_hid), np.asarray(hid), rtol=2.5e-7, atol=0)
        hq, hs = pk._quant_rows(hid)
        t_hq, t_hs = kernels.quant_rows_plain(t_hid)
        out = x1 + (pk._int8_matmul(hq, hs, jq["wproj"], jq["sproj"]) + jq["bproj"]
                    ).astype(jd).reshape(B, L, D)
        same(kernels.gemm_int8_epilogue_plain(port(hq), port(hs), q["wproj"], q["sproj"],
                                              q["bproj"], "dequant_bias_residual", td,
                                              residual=port(x1).reshape(B * L, D)),
             out.reshape(B * L, D))
    same(t_hq, hq)
    same(t_hs, hs)
    for ours, ours_s, ref, ref_s in ((t_h1q, t_h1s, h1q, h1s), (t_h2q, t_h2s, h2q, h2s)):
        assert_ln_quant_close(ours.reshape(B * L, D), ours_s.reshape(B * L, 1), ref, ref_s)


def assert_ln_quant_close(q, s, ref_q, ref_s):
    """The rule for the LayerNorm quantizer, whose statistics sum in
    another order: codes equal in >= 99.9%, never more than one step apart,
    scales within 1e-6 relative."""
    step = np.abs(q.numpy().astype(np.int32) - np.asarray(ref_q, np.int32))
    assert step.max() <= 1 and (step == 0).mean() >= 0.999
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,causal", [(50, False), (13, True)])
def test_int8_block_plain_matches_tpu_body_op_by_op(rng, L, causal, dtype):
    """The whole plain block against the JAX body run op by op.

    bf16: bit-identical at these inputs.  fp32: the attention's fp32 sums
    run in another order on the two sides, and the ulps this leaves can
    move an int8 code that lies on a rounding tie by one step; at L=50 one
    code does (max|diff|/max|ref| 5.6e-4), at L=13 none (1.7e-7).  The
    stage test above holds every step bit for bit; here fp32 is held to a
    tenth of a quantization step's reach, cosine > 0.999999.
    """
    B, D, H = 4, 128, 4
    jd, td = DTYPES[dtype]
    jq, q, _ = jax_qblock(D)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    ours = np32(kernels.fused_transformer_block_int8_plain(T(x, td), q, H, causal))
    ref = np.asarray(_jax_body_op_by_op(jnp.asarray(x, jd), jq, H, causal).astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(ours, ref)
    else:
        assert np.abs(ours - ref).max() / np.abs(ref).max() < 1e-3
        assert cosine(ours, ref) > 0.999999


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,causal", [(50, False), (13, True)])
def test_int8_block_plain_matches_pallas_interpret(rng, L, causal, dtype):
    """Against the interpret-mode call.  Compiled, XLA keeps excess
    precision across the bf16 casts and turns ``amax / 127`` into a product
    with the reciprocal, an ulp off the division the kernel's source and
    the port do (ROADMAP.md queue 3).  The scales' ulps move int8 codes on
    rounding ties by one step, up to 5.5e-3 of max|ref| at these inputs, so
    both dtypes are held to quantization-step bars: fp32 rel < 1e-2 and
    cosine > 0.99999, bf16 rel < 2e-2 and cosine > 0.9999."""
    B, D, H = 4, 128, 4
    jd, td = DTYPES[dtype]
    jq, q, _ = jax_qblock(D)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    ours = np32(kernels.fused_transformer_block_int8(T(x, td), q, H, causal))
    ref = np.asarray(pk.fused_transformer_block_int8(jnp.asarray(x, jd), jq, H, causal=causal,
                                                     interpret=True).astype(jnp.float32))
    assert_int8_block_close(ours, ref, dtype)


def assert_int8_block_close(ours, ref, dtype):
    rel = np.abs(ours - ref).max() / np.abs(ref).max()
    if dtype == "float32":
        assert rel < 1e-2 and cosine(ours, ref) > 0.99999
    else:
        assert rel < 2e-2 and cosine(ours, ref) > 0.9999


@pytest.mark.parametrize("L,causal,D,H,B", [
    (50, False, 128, 4, 4), (13, True, 128, 4, 4), (257, False, 1024, 16, 1),
])
def test_int8_block_plain_close_to_residual_block(rng, L, causal, D, H, B):
    """Within quantization noise of the fp32 XLA block, at the JAX
    package's bars (tests/test_pallas.py:189-217), ViT-L/14's geometry
    included."""
    stacked = jax_init_block_params(jax.random.PRNGKey(0), 1, D)
    jblk = jax.tree_util.tree_map(lambda a: a[0], stacked)
    blk = clip._blocks_from_jax(np_tree(stacked))[0]
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    ours = np32(kernels.fused_transformer_block_int8_plain(T(x), kernels.quantize_block(blk),
                                                           H, causal))
    ref = np.asarray(jax_residual_block(jnp.asarray(x), jblk, H, causal=causal))
    assert cosine(ours, ref) > 0.999
    assert np.abs(ours - ref).max() / np.abs(ref).max() < 0.02


@pytest.mark.parametrize("causal", [False, True])
def test_int8_block_length_contract_matches_pallas(rng, causal):
    """Pre-padded input with ``length``: keys past it are masked and the
    output keeps the padded shape (tests/test_pallas.py:156-176)."""
    B, L, D, H, lp = 2, 13, 128, 4, 16
    jq, q, _ = jax_qblock(D)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    xp = np.pad(x, [(0, 0), (0, lp - L), (0, 0)])
    ours = np32(kernels.fused_transformer_block_int8(T(xp), q, H, causal, length=L))
    assert ours.shape == (B, lp, D)
    ref = np.asarray(pk.fused_transformer_block_int8(jnp.asarray(xp), jq, H, causal=causal,
                                                     length=L, interpret=True))
    assert_int8_block_close(ours, ref, "float32")
    unpadded = np32(kernels.fused_transformer_block_int8(T(x), q, H, causal))
    np.testing.assert_allclose(ours[:, :L], unpadded, rtol=0, atol=1e-5)  # fp32 sum order


def test_int8_wrappers_take_plain_versions_on_cpu(rng):
    B, L, D, H = 2, 11, 64, 4
    _, q, _ = jax_qblock(D)
    x = T(rng.standard_normal((B, L, D)))
    kernels.reset_launch_counts()
    s, b = q["ln1s"], q["ln1b"]
    for got, want in ((kernels.quant_rows(x), kernels.quant_rows_plain(x)),
                      (kernels.layernorm_quant_rows(x, s, b),
                       kernels.layernorm_quant_rows_plain(x, s, b))):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    a_q, a_s = kernels.quant_rows_plain(x)
    for epi, res in (("dequant_bias", None), ("dequant_bias_residual", x),
                     ("dequant_bias_gelu", None)):
        got = kernels.gemm_int8_epilogue(a_q, a_s, q["wo"], q["so"], q["bo"], epi,
                                         torch.float32, residual=res)
        assert torch.equal(got, kernels.gemm_int8_epilogue_plain(
            a_q, a_s, q["wo"], q["so"], q["bo"], epi, torch.float32, residual=res))
    assert torch.equal(kernels.fused_transformer_block_int8(x, q, H, True),
                       kernels.fused_transformer_block_int8_plain(x, q, H, True))
    assert set(kernels.launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="unknown epilogue"):
        kernels.gemm_int8_epilogue(a_q, a_s, q["wo"], q["so"], q["bo"], "bias", torch.float32)
    with pytest.raises(ValueError, match="residual"):
        kernels.gemm_int8_epilogue(a_q, a_s, q["wo"], q["so"], q["bo"],
                                   "dequant_bias_residual", torch.float32)
    with pytest.raises(ValueError, match="must divide"):
        kernels.fused_transformer_block_int8(x, q, 5)


# -- wiring: load_clip, the towers, the serving encode -----------------------------------


@pytest.fixture()
def tiny_weights(tmp_path_factory):
    """The tiny torch-layout state dict of tests/test_models.py in a file."""
    path = tmp_path_factory.mktemp("int8") / "tiny_clip.pt"
    sd = _tiny_torch_style_state_dict(np.random.default_rng(0))
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    return str(path)


def test_int8_enabled_matches_jax(monkeypatch):
    for value in ("1", "true", "ON", "0", "off", "yes", ""):
        monkeypatch.setenv("PROTOCLIP_INT8", value)
        assert kernels.int8_enabled() == pk.int8_enabled(), value
    monkeypatch.delenv("PROTOCLIP_INT8")
    assert not kernels.int8_enabled()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_clip_quantizes_at_load_as_jax(tiny_weights, monkeypatch, dtype):
    jd, td = DTYPES[dtype]
    monkeypatch.setenv("PROTOCLIP_INT8", "0")
    cfg, plain = clip.load_clip("tiny", tiny_weights, dtype=td, device="cpu")
    assert "blocks_q" not in plain["visual"]
    monkeypatch.setenv("PROTOCLIP_INT8", "1")
    _, params = clip.load_clip("tiny", tiny_weights, dtype=td, device="cpu")
    _, jparams = jclip.load_clip("tiny", tiny_weights, dtype=jd)  # Pallas off: not quantized
    jq = np_tree(jclip.quantize_for_serving(jparams))
    for tower in ("visual", "text"):
        ours = params[tower]["blocks_q"]
        ref = dict(leaves(clip._qblocks_from_jax(jq[tower]["blocks_q"])))
        with jax.disable_jit():
            eager = dict(leaves(clip._qblocks_from_jax(np_tree(
                pk.quantize_stacked_blocks(jparams[tower]["blocks"])))))
        assert len(ours) == 2
        for key, value in leaves(ours):
            assert torch.equal(value, eager[key]), (tower, key)
            # quantize_for_serving runs under jit, where XLA multiplies by
            # 1/127: its scales are within an ulp of the division, and a
            # weight on an exact rounding tie (common in bf16) may land a
            # step away
            leaf = key.split("/")[-1]
            if leaf in ("sqkv", "so", "sfc", "sproj"):
                np.testing.assert_allclose(value.numpy(), ref[key].numpy(), rtol=1.2e-7, atol=0)
            elif leaf in ("wqkv", "wo", "wfc", "wproj"):
                step = np.abs(value.numpy().astype(np.int32) - ref[key].numpy())
                assert step.max() <= 1 and (step == 0).mean() >= 0.999, (tower, key)
            else:
                assert torch.equal(value, ref[key]), (tower, key)
        assert ours[0]["wqkv"].dtype == torch.int8 and ours[0]["sqkv"].dtype == torch.float32
    # cast_params passes the int8 layers through untouched
    casted = clip.cast_params(params, torch.bfloat16)
    assert casted["visual"]["blocks_q"][1]["wfc"] is params["visual"]["blocks_q"][1]["wfc"]
    assert casted["visual"]["blocks_q"][1]["bfc"].dtype == torch.float32
    # params_from_jax carries the JAX tree across unchanged
    carried = clip.params_from_jax(jq, cfg, dtype=td, device="cpu")
    for key, value in leaves(carried["text"]["blocks_q"]):
        assert torch.equal(value, dict(leaves(clip._qblocks_from_jax(
            jq["text"]["blocks_q"])))[key]), key
    assert carried["text"]["blocks_q"][0]["wqkv"].shape == (3 * 64, 64)


def test_towers_route_every_layer_through_k3(monkeypatch, rng):
    calls = []
    orig = port_layers.fused_transformer_block_int8

    def counting(x, qblock, n_head, causal=False, length=None):
        calls.append(causal)
        return orig(x, qblock, n_head, causal=causal, length=length)

    monkeypatch.setattr(port_layers, "fused_transformer_block_int8", counting)
    monkeypatch.setattr(port_layers, "fused_transformer_block",
                        lambda *a, **k: pytest.fail("K2 ran in the int8 mode"))
    monkeypatch.setenv("PROTOCLIP_INT8", "1")
    cfg = port_config(TINY_VIT)
    params = clip.quantize_for_serving(
        clip.params_from_jax(np_tree(jclip.init_clip_params(jax.random.PRNGKey(0), TINY_VIT)),
                             cfg, device="cpu"))
    images = torch.from_numpy((rng.standard_normal((2, 32, 32, 3)) * 0.5).astype(np.float32))
    tokens = torch.from_numpy(tiny_tokens(rng, 2, TINY_VIT.context_length, TINY_VIT.vocab_size))
    clip.encode_image(params, images, cfg)
    clip.encode_text(params, tokens, cfg)
    assert calls == [False] * TINY_VIT.vision_layers + [True] * TINY_VIT.transformer_layers
    # without load-time int8 layers the towers quantize per call, to the same layers
    calls.clear()
    del params["visual"]["blocks_q"]
    clip.encode_image(params, images, cfg)
    assert calls == [False] * TINY_VIT.vision_layers


def test_int8_towers_match_jax_int8_towers(monkeypatch, rng):
    """The same int8 layers (JAX's ``quantize_for_serving``, carried across)
    through both packages' int8 towers; JAX's under ``$PROTOCLIP_PALLAS``
    with the kernel forced into interpret mode, as tests/test_pallas.py
    forces it."""
    monkeypatch.setenv("PROTOCLIP_INT8", "1")
    monkeypatch.setenv("PROTOCLIP_PALLAS", "1")
    monkeypatch.setenv("PROTOCLIP_PALLAS_INTERPRET", "1")
    jparams = jclip.quantize_for_serving(jclip.init_clip_params(jax.random.PRNGKey(0), TINY_VIT))
    cfg = port_config(TINY_VIT)
    params = clip.params_from_jax(np_tree(jparams), cfg, device="cpu")
    assert len(params["visual"]["blocks_q"]) == TINY_VIT.vision_layers
    images = (rng.standard_normal((3, 32, 32, 3)) * 0.5).astype(np.float32)
    tokens = tiny_tokens(rng, 3, TINY_VIT.context_length, TINY_VIT.vocab_size)
    with torch.inference_mode():
        img = clip.encode_image(params, torch.from_numpy(images), cfg).numpy()
        txt = clip.encode_text(params, torch.from_numpy(tokens), cfg).numpy()
    j_img = np.asarray(jclip.encode_image(jparams, jnp.asarray(images), TINY_VIT))
    j_txt = np.asarray(jclip.encode_text(jparams, jnp.asarray(tokens), TINY_VIT))
    assert row_cosines(img, j_img).min() > 0.999
    assert row_cosines(txt, j_txt).min() > 0.999


def test_make_encode_fn_matches_jax(rng):
    from protoclip_tpu.io.export import make_encode_fn as jax_make_encode_fn
    from protoclip_tpu_torch.io import make_encode_fn

    jparams = jclip.init_clip_params(jax.random.PRNGKey(0), TINY_VIT)
    cfg = port_config(TINY_VIT)
    params = clip.params_from_jax(np_tree(jparams), cfg, device="cpu")
    images = rng.integers(0, 256, (4, 32, 32, 3)).astype(np.uint8)
    for normalize in (True, False):
        ours = make_encode_fn(cfg, normalize)(params, torch.from_numpy(images))
        ref = np.asarray(jax_make_encode_fn(TINY_VIT, normalize)(jparams, jnp.asarray(images)))
        assert ours.dtype == torch.float32 and ours.shape == (4, TINY_VIT.embed_dim)
        assert row_cosines(ours.numpy(), ref).min() >= 0.999
        if normalize:
            np.testing.assert_allclose(ours.norm(dim=-1).numpy(), 1.0, atol=1e-5)


# -- the extract CLI ---------------------------------------------------------------------


@pytest.fixture()
def image_tree(tmp_path):
    """PNGs and JPEGs of several sizes in nested folders, plus files the
    walk must skip."""
    from PIL import Image

    rng = np.random.default_rng(3)
    root = tmp_path / "images"
    sizes = [(40, 52), (32, 32), (64, 37), (45, 45), (33, 70)]
    for i, (w, h) in enumerate(sizes):
        sub = root / ("b" if i % 2 else "a") / ("deep" if i == 4 else "")
        sub.mkdir(parents=True, exist_ok=True)
        pixels = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        ext = ".JPG" if i == 3 else ".png"
        Image.fromarray(pixels).save(sub / f"img{4 - i}{ext}")
    (root / "a" / "notes.txt").write_text("not an image")
    return str(root)


def _run_cli(main, monkeypatch, args):
    monkeypatch.setattr("sys.argv", ["extract", *args])
    main()


def _load(path):
    with np.load(path) as z:
        return list(z["files"]), z["features"]


def test_extract_cli_matches_jax_cli(tiny_weights, image_tree, tmp_path, monkeypatch):
    from protoclip_tpu.cli.extract import main as jax_main
    from protoclip_tpu_torch.cli.extract import main

    monkeypatch.setenv("PROTOCLIP_INT8", "0")
    common = ["--backbone", "tiny", "--weights", tiny_weights, "--input", image_tree,
              "--batch", "3"]
    _run_cli(jax_main, monkeypatch, [*common, "--out", str(tmp_path / "jax.npz")])
    _run_cli(main, monkeypatch, [*common, "--out", str(tmp_path / "port"), "--device", "cpu"])
    j_files, j_feats = _load(tmp_path / "jax.npz")
    files, feats = _load(tmp_path / "port.npz")  # ".npz" appended as the JAX CLI does
    assert files == j_files and len(files) == 5
    assert files == sorted(files, key=lambda f: (os.path.dirname(f), os.path.basename(f)))
    assert feats.dtype == np.float32 and feats.shape == (5, TINY_VIT.embed_dim)
    np.testing.assert_allclose(np.linalg.norm(feats, axis=-1), 1.0, atol=1e-5)
    assert row_cosines(feats, j_feats).min() >= 0.999


def test_extract_cli_int8_on_cpu_runs_the_plain_k3(tiny_weights, image_tree, tmp_path,
                                                   monkeypatch):
    """``--int8 --device cpu`` encodes with K3's plain version, not bf16."""
    from protoclip_tpu_torch.cli.extract import _find_images, main
    from protoclip_tpu_torch.data.transforms import clip_preprocess, load_image
    from protoclip_tpu_torch.io import make_encode_fn

    calls = []
    orig = kernels.fused_transformer_block_int8_plain
    monkeypatch.setattr(kernels, "fused_transformer_block_int8_plain",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    monkeypatch.setenv("PROTOCLIP_INT8", "0")  # restored after the CLI turns it on
    _run_cli(main, monkeypatch, ["--backbone", "tiny", "--weights", tiny_weights, "--input",
                                 image_tree, "--out", str(tmp_path / "q.npz"), "--batch", "8",
                                 "--int8", "--device", "cpu"])
    files, feats = _load(tmp_path / "q.npz")
    assert len(calls) == 2  # the tiny image tower's two layers, one batch
    assert os.environ["PROTOCLIP_INT8"] == "1"
    cfg, params = clip.load_clip("tiny", tiny_weights, dtype=torch.bfloat16, device="cpu")
    assert "blocks_q" in params["visual"]
    batch = np.zeros((8, 32, 32, 3), np.uint8)  # the CLI's fixed batch
    for i, path in enumerate(_find_images(image_tree)):
        batch[i] = clip_preprocess(load_image(path), 32)
    ref = make_encode_fn(cfg)(params, torch.from_numpy(batch))[:len(files)]
    np.testing.assert_array_equal(feats, ref.numpy())
    monkeypatch.delenv("PROTOCLIP_INT8")
    _, bf16 = clip.load_clip("tiny", tiny_weights, dtype=torch.bfloat16, device="cpu")
    assert not np.array_equal(feats, make_encode_fn(cfg)(bf16, torch.from_numpy(batch))[:5])


def test_extract_cli_needs_the_card_unless_told_cpu(tiny_weights, image_tree, tmp_path,
                                                    monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    from protoclip_tpu_torch.cli.extract import main

    args = ["--weights", tiny_weights, "--input", image_tree, "--out", str(tmp_path / "f.npz")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _run_cli(main, monkeypatch, args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):  # a mesh of cards too
        _run_cli(main, monkeypatch, [*args, "--mesh", "2"])
    assert not (tmp_path / "f.npz").exists()
    # told cpu, --mesh 2 runs on two CPU shards, each row as the unsharded
    # run's at the same per-shard batch
    _run_cli(main, monkeypatch, [*args, "--mesh", "2", "--device", "cpu", "--batch", "4"])
    files_meshed, meshed = _load(tmp_path / "f.npz")
    _run_cli(main, monkeypatch, [*args, "--device", "cpu", "--batch", "2"])
    files, single = _load(tmp_path / "f.npz")
    assert files_meshed == files
    np.testing.assert_array_equal(meshed, single)


def test_preprocess_copy_matches_jax(image_tree):
    from protoclip_tpu.cli.extract import _find_images as jax_find_images
    from protoclip_tpu.data import transforms as jt
    from protoclip_tpu_torch.cli.extract import _find_images
    from protoclip_tpu_torch.data import transforms as tt

    files = _find_images(image_tree)
    assert files == jax_find_images(image_tree)
    for path in files:
        for n_px, draft in ((32, None), (24, 24)):
            np.testing.assert_array_equal(tt.clip_preprocess(tt.load_image(path, draft), n_px),
                                          jt.clip_preprocess(jt.load_image(path, draft), n_px))
        img = tt.load_image(path)
        assert tt.center_crop(tt.resize_shorter(img, 20), 20).size == (20, 20)


# -- chip_smoke.py covers every kernel -----------------------------------------------------


def test_chip_smoke_lists_every_kernel():
    """Every launch counter, and every site of the block-variant bench, has
    a row in the contract line, whose source exists and whose TPU kernel is
    a line of the Pallas module or of the bench; the bench's rows come from
    its variants path."""
    import chip_smoke
    from protoclip_tpu_torch.ops import block_variants

    assert not set(kernels.LAUNCHES) & set(block_variants.SITE_CALLS)
    assert set(chip_smoke.KERNEL_SOURCES) == set(kernels.LAUNCHES) | set(block_variants.SITE_CALLS)
    for name, (source, replaces, path) in chip_smoke.KERNEL_SOURCES.items():
        assert os.path.exists(source), name
        file, line = replaces.split(":")
        assert file in ("protoclip_tpu/ops/pallas_kernels.py", "scripts/bench_block_variants.py"), name
        with open(file) as fh:
            assert 0 < int(line) <= len(fh.readlines()), name
        if file.startswith("scripts/"):
            assert path == "variants", name
        else:  # "eva", "bige": the EVA-CLIP backbones' phases; "times": K1 and K4, which no
            # path runs
            assert path in ("main", "main_int8", "times", "eva", "bige"), name
