"""EVA02-CLIP-bigE-14-plus on the port, on the CPU: the post-norm image
tower and the exact-GELU text tower against the plain fp32 reference
(``tests/eva_postnorm_reference.py``), EVA-CLIP's post-norm state-dict
layout through the normal entry points, the post-norm block and its
residual LayerNorm, the layout's detection beside EVA02's, planted faults
the comparison must catch, and the refusals of K3, bundles and fp32 on the
card.

Tiny geometry: width 64, 2 heads of 32, 2 blocks, 56 px at patch 14, MLP
480; text 64 wide, 1 head, 2 layers.  Its shapes are registered for the
tests (the state dict says neither that its blocks are post-norm nor its
head count).

Tolerances (each the worst row's ``|port - ref| / |ref|``):

- ``FP32_TOL`` 1e-5: the port's plain versions in fp32 against the
  reference differ only in the order of fp32 sums (~1e-6 at these sizes);
  each planted fault below moves the features by more;
- ``BF16_TOL`` 3e-2: the bf16 path rounds every activation (2^-9 each)
  through 2 blocks.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from protoclip_tpu_torch.core.config import Config
from protoclip_tpu_torch.data.loader import ArrayLoader
from protoclip_tpu_torch.data.transforms import normalize_batch
from protoclip_tpu_torch.memory.banks import encode_loader
from protoclip_tpu_torch.models import clip, eva
from protoclip_tpu_torch.ops import kernels
from protoclip_tpu_torch.train.runner import make_encode_fns
from tests.eva_postnorm_reference import TINY, EvaPostnormCLIP, postnorm_state_dict

FP32_TOL = 1e-5
BF16_TOL = 3e-2
BACKBONE = "EVA02-CLIP-bigE-14-plus"
TINY_NAME = "EVA02-CLIP-postnorm-tiny"
TINY_CFG = clip.CLIPConfig(
    TINY_NAME, TINY["embed"], TINY["px"], TINY["layers"], TINY["width"], TINY["patch"],
    context_length=TINY["context"], vocab_size=TINY["vocab"], transformer_width=TINY["text_width"],
    transformer_layers=TINY["text_layers"], n_vision_heads=TINY["heads"],
    vision_block=eva.POSTNORM, vision_mlp_width=TINY["hidden"], text_act="gelu")


@pytest.fixture(autouse=True)
def registered(monkeypatch):
    monkeypatch.setitem(clip.PORT_BACKBONE_CONFIGS, TINY_NAME, TINY_CFG)


def _reference(sd, act="gelu"):
    return EvaPostnormCLIP(sd, TINY["heads"], TINY["text_heads"], act)


def _rel_err(got, ref):
    got, ref = got.double(), ref.double()
    return float(((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max())


def _tokens(seed, n):
    rng = np.random.default_rng(seed)
    tok = np.zeros((n, TINY["context"]), np.int64)
    for i in range(n):
        length = int(rng.integers(3, TINY["context"]))
        tok[i, :length] = rng.integers(1, TINY["vocab"] - 1, length)
        tok[i, length - 1] = TINY["vocab"] - 1  # EOT: the largest id
    return torch.from_numpy(tok)


def _images(seed, n):
    px = TINY["px"]
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (n, px, px, 3),
                                                                 dtype=np.uint8))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The synthetic state dict, its file, and the port's fp32 load of it."""
    sd = postnorm_state_dict(0)
    path = str(tmp_path_factory.mktemp("eva_postnorm") / "postnorm_tiny.pt")
    torch.save(sd, path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(clip.PORT_BACKBONE_CONFIGS, TINY_NAME, TINY_CFG)
        cfg, params = clip.load_clip(TINY_NAME, path, dtype=torch.float32, device="cpu",
                                     int8=False)
    return sd, path, cfg, params


def _encode(params, cfg, images):
    with torch.no_grad():
        return clip.encode_image(params, normalize_batch(images), cfg)


# -- registry and layout --------------------------------------------------------------------


def test_the_registry_holds_bige_at_its_published_widths():
    cfg = clip.backbone_config(BACKBONE)
    assert cfg is clip.PORT_BACKBONE_CONFIGS[BACKBONE] and cfg.is_eva
    assert BACKBONE not in clip.BACKBONE_CONFIGS and BACKBONE not in clip.available_backbones()
    assert (cfg.vision_block, cfg.vision_width, cfg.vision_layers, cfg.vision_heads,
            cfg.vision_width // cfg.vision_heads, cfg.vision_patch_size, cfg.image_resolution,
            cfg.vision_mlp_width) == (eva.POSTNORM, 1792, 64, 16, 112, 14, 224,
                                      int(1792 * 8.571428571428571))
    assert cfg.vision_mlp_width == 15360 and (224 // 14) ** 2 + 1 == 257
    assert (cfg.transformer_width, cfg.transformer_heads, cfg.transformer_layers,
            cfg.embed_dim, cfg.context_length, cfg.vocab_size, cfg.text_act) == (
        1280, 20, 32, 1024, 77, 49408, "gelu")


def _shapes_only(shapes, layers, text_layers):
    shapes.update({f"visual.blocks.{i}.norm1.weight": (1,) for i in range(layers)})
    shapes.update({f"text.transformer.resblocks.{i}.ln_1.weight": (1,)
                   for i in range(text_layers)})
    return {k: np.zeros(s) for k, s in shapes.items()}


def test_each_layout_is_inferred_by_its_keys():
    text = {"text.positional_embedding": (77, 1280), "text.token_embedding.weight": (49408, 1280),
            "text.ln_final.weight": (1280,)}
    bige = _shapes_only({"visual.patch_embed.proj.weight": (1792, 3, 14, 14),
                         "visual.pos_embed": (1, 257, 1792), "visual.head.weight": (1024, 1792),
                         "visual.blocks.0.attn.qkv.weight": (1,),
                         "visual.blocks.0.mlp.fc1.weight": (15360, 1792), **text}, 64, 32)
    assert clip.infer_config_from_state_dict(bige) == clip.PORT_BACKBONE_CONFIGS[BACKBONE]
    eva02 = _shapes_only({"visual.patch_embed.proj.weight": (1024, 3, 14, 14),
                          "visual.pos_embed": (1, 577, 1024), "visual.head.weight": (768, 1024),
                          "visual.blocks.0.attn.q_proj.weight": (1,),
                          "visual.blocks.0.mlp.w1.weight": (2730, 1024),
                          "visual.blocks.0.mlp.w3.weight": (1,),
                          "text.positional_embedding": (77, 768),
                          "text.token_embedding.weight": (49408, 768),
                          "text.ln_final.weight": (768,)}, 24, 12)
    assert clip.infer_config_from_state_dict(eva02) == clip.PORT_BACKBONE_CONFIGS[
        "EVA02-CLIP-L-14-336"]
    # a post-norm state dict of no registered shape: its keys say neither
    # that it is post-norm nor its head count
    other = dict(bige, **{"visual.blocks.0.mlp.fc1.weight": np.zeros((7168, 1792))})
    with pytest.raises(ValueError, match="no registered post-norm backbone"):
        clip.infer_config_from_state_dict(other)
    neither = {k: v for k, v in bige.items() if k != "visual.blocks.0.mlp.fc1.weight"}
    with pytest.raises(ValueError, match="neither EVA02's sub-LN block"):
        clip.infer_config_from_state_dict(neither)


def test_the_layout_round_trips(tiny):
    """Port parameters -> EVA-CLIP's keys gives the state dict back: the
    fused QKV transposed, its bias [bq, 0, bv], fc1 / fc2 transposed."""
    sd, _, cfg, params = tiny
    assert cfg == TINY_CFG and cfg.rope_pt_grid is None
    w, vis = TINY["width"], params["visual"]
    assert "rope" not in vis
    for i, blk in enumerate(vis["blocks"]):
        p, at, mlp = f"visual.blocks.{i}", blk["attn"], blk["mlp"]
        assert set(blk) == {"ln_1", "attn", "ln_2", "mlp"}
        torch.testing.assert_close(at["bqkv"][:w], sd[p + ".attn.q_bias"], rtol=0, atol=0)
        assert not at["bqkv"][w:2 * w].any()
        torch.testing.assert_close(at["bqkv"][2 * w:], sd[p + ".attn.v_bias"], rtol=0, atol=0)
        back = {p + ".attn.qkv.weight": at["wqkv"].T, p + ".attn.proj.weight": at["wo"].T,
                p + ".attn.proj.bias": at["bo"], p + ".mlp.fc1.weight": mlp["w_fc"].T,
                p + ".mlp.fc1.bias": mlp["b_fc"], p + ".mlp.fc2.weight": mlp["w_proj"].T,
                p + ".mlp.fc2.bias": mlp["b_proj"], p + ".norm1.weight": blk["ln_1"]["scale"],
                p + ".norm1.bias": blk["ln_1"]["bias"], p + ".norm2.weight": blk["ln_2"]["scale"],
                p + ".norm2.bias": blk["ln_2"]["bias"]}
        for key, value in back.items():
            torch.testing.assert_close(value, sd[key], rtol=0, atol=0)
            assert value.is_contiguous() or value.T.is_contiguous()
    assert mlp["w_fc"].shape == (w, TINY["hidden"]) and mlp["w_fc"].is_contiguous()
    pe = vis["patch_embed"].reshape(14, 14, 3, w).permute(3, 2, 0, 1)
    torch.testing.assert_close(pe, sd["visual.patch_embed.proj.weight"], rtol=0, atol=0)
    torch.testing.assert_close(vis["head"]["w"].T, sd["visual.head.weight"], rtol=0, atol=0)


def _assert_load_is_cast_conversion(weights, sd, dtype):
    _, direct = clip.load_clip(TINY_NAME, weights, dtype=dtype, device="cpu", int8=False)
    _, params = clip.convert_clip_state_dict(sd)
    want = clip.cast_params(params, dtype)

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, path + (i,))
        else:
            yield path, tree

    got = dict(leaves(direct))
    assert got.keys() == dict(leaves(want)).keys()
    for path, value in leaves(want):
        assert got[path].dtype == value.dtype, path
        assert got[path].is_contiguous(), path
        torch.testing.assert_close(got[path], value, rtol=0, atol=0)


def test_a_bf16_load_converts_block_by_block_into_what_cast_params_gives(tiny):
    sd, path, _, _ = tiny
    _assert_load_is_cast_conversion(path, sd, torch.bfloat16)


def test_an_fp32_load_converts_block_by_block_into_convert_clip_state_dict(tiny):
    """load_clip's streaming converter and the fp32 one agree bit for bit."""
    sd, path, _, _ = tiny
    _assert_load_is_cast_conversion(path, sd, torch.float32)


# -- the residual LayerNorm and the block --------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_layernorm_residual_rows_plain_is_x_plus_the_rounded_layernorm(dtype):
    g = torch.Generator().manual_seed(1)
    a, x = torch.randn(3, 5, 1792, generator=g) * 4, torch.randn(3, 5, 1792, generator=g)
    scale, bias = 1 + 0.1 * torch.randn(1792, generator=g), 0.1 * torch.randn(1792, generator=g)
    a, x = a.to(dtype), x.to(dtype)
    ln = F.layer_norm(a.float(), (1792,), scale, bias, kernels.EVA_LN_EPS)
    out = kernels.layernorm_residual_rows(a, x, scale, bias)
    assert out.dtype == dtype and out.shape == x.shape
    want = (x.float() + ln.to(dtype).float()).to(dtype)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    # the LayerNorm's input is a, not x + a (the pre-norm residual)
    assert (out.float() - F.layer_norm((x + a).float(), (1792,), scale, bias)).abs().max() > 1
    # in bf16 the LayerNorm is rounded before the sum: one rounding less differs
    if dtype == torch.bfloat16:
        assert not torch.equal(out, (x.float() + ln).to(dtype))


def _block(seed, d=TINY["width"], hidden=TINY["hidden"], dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)

    def n(*shape, std):
        return (torch.randn(*shape, generator=g) * std).to(dtype)

    def ln():
        return {"scale": 1 + 0.1 * torch.randn(d, generator=g),
                "bias": 0.05 * torch.randn(d, generator=g)}

    bqkv = n(3 * d, std=0.02)
    bqkv[d:2 * d] = 0
    return {"ln_1": ln(), "ln_2": ln(),
            "attn": {"wqkv": n(d, 3 * d, std=d ** -0.5), "bqkv": bqkv,
                     "wo": n(d, d, std=d ** -0.5), "bo": n(d, std=0.02)},
            "mlp": {"w_fc": n(d, hidden, std=d ** -0.5), "b_fc": n(hidden, std=0.02),
                    "w_proj": n(hidden, d, std=hidden ** -0.5), "b_proj": n(d, std=0.02)}}


def _by_hand(x, blk, heads, dtype):
    """A post-norm block written out with its cast points (T: ``dtype``)."""
    def t(v):
        return v.to(dtype).float()

    b, n, d = x.shape
    at, mlp = blk["attn"], blk["mlp"]
    xf = x.float()
    qkv = t(t(xf @ at["wqkv"].float()) + at["bqkv"].float())
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, n, heads, -1).transpose(1, 2)
               for i in range(3))
    w = t(torch.softmax((q * (d // heads) ** -0.5) @ k.transpose(-1, -2), dim=-1))
    o = t((w @ v).transpose(1, 2).reshape(b, n, d))
    a = t(t(o @ at["wo"].float()) + at["bo"].float())
    xf = t(xf + t(F.layer_norm(a, (d,), blk["ln_1"]["scale"], blk["ln_1"]["bias"], 1e-6)))
    h = t(F.gelu(xf @ mlp["w_fc"].float() + mlp["b_fc"].float()))
    m = t(t(h @ mlp["w_proj"].float()) + mlp["b_proj"].float())
    return t(xf + t(F.layer_norm(m, (d,), blk["ln_2"]["scale"], blk["ln_2"]["bias"], 1e-6)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_the_block_plain_matches_a_block_written_by_hand(dtype):
    blk = _block(2, dtype=dtype)
    x = torch.randn(2, 17, TINY["width"], generator=torch.Generator().manual_seed(3)).to(dtype)
    out = kernels.fused_eva_postnorm_block(x, blk, TINY["heads"])
    assert out.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), _by_hand(x, blk, TINY["heads"], dtype),
                               rtol=tol, atol=tol)


# -- the towers against the reference ----------------------------------------------------------


def test_image_tower_matches_the_reference_in_fp32(tiny):
    sd, _, cfg, params = tiny
    images = _images(7, 4)
    ref = _reference(sd).encode_image(normalize_batch(images))
    assert _rel_err(_encode(params, cfg, images), ref) < FP32_TOL


def test_text_tower_matches_the_reference_in_fp32(tiny):
    sd, _, cfg, params = tiny
    tokens = _tokens(8, 5)
    with torch.no_grad():
        port = clip.encode_text(params, tokens, cfg)
    assert _rel_err(port, _reference(sd).encode_text(tokens)) < FP32_TOL
    assert _rel_err(port, _reference(sd, act="quick_gelu").encode_text(tokens)) > 100 * FP32_TOL


def _pre_norm_chain(x, p, n_head, ln_residual, gemm, attention):
    d = x.shape[-1]
    h = kernels.layernorm_rows_plain(x, p["ln1s"], p["ln1b"], kernels.EVA_LN_EPS)
    qkv = gemm(h, p["wqkv"], p["bqkv"], "bias")
    attn = attention(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], n_head)
    x = gemm(attn, p["wo"], p["bo"], "bias_residual", residual=x)
    h = kernels.layernorm_rows_plain(x, p["ln2s"], p["ln2b"], kernels.EVA_LN_EPS)
    hid = gemm(h, p["wfc"], p["bfc"], "bias_gelu_erf")
    return gemm(hid, p["wproj"], p["bproj"], "bias_residual", residual=x)


def _tanh_gelu(a, w, bias, epilogue, residual=None, exact=kernels.gemm_bias_epilogue_plain):
    if epilogue == "bias_gelu_erf":
        return F.gelu(a.float() @ w.float() + bias.float(), approximate="tanh").to(a.dtype)
    return exact(a, w, bias, epilogue, residual)


@pytest.mark.parametrize("fault", ["pre_norm", "k_bias", "tanh_gelu"])
def test_planted_faults_fail_the_comparison(tiny, monkeypatch, fault):
    """A pre-norm block in place of the post-norm one, the bias laid out as
    [bq, bv, 0] (v's bias on k, none on v), and the tanh GELU in the image
    MLP each move the features past FP32_TOL.  A bias on k alone would not:
    it shifts each query's scores by one constant, which the softmax takes
    away (why EVA-CLIP has none)."""
    sd, _, cfg, params = tiny
    if fault == "pre_norm":
        monkeypatch.setattr(kernels, "_eva_postnorm_block_chain", _pre_norm_chain)
    elif fault == "k_bias":
        w = TINY["width"]
        params = {**params, "visual": {**params["visual"], "blocks": [
            {**b, "attn": {**b["attn"], "bqkv": torch.cat([b["attn"]["bqkv"][:w],
                                                           b["attn"]["bqkv"][2 * w:],
                                                           b["attn"]["bqkv"][w:2 * w]])}}
            for b in params["visual"]["blocks"]]}}
    else:
        monkeypatch.setattr(kernels, "gemm_bias_epilogue_plain", _tanh_gelu)
    images = _images(7, 4)
    ref = _reference(sd).encode_image(normalize_batch(images))
    assert _rel_err(_encode(params, cfg, images), ref) > FP32_TOL


def test_image_tower_in_bf16(tiny):
    sd, path, _, _ = tiny
    cfg, params = clip.load_clip(TINY_NAME, path, dtype=torch.bfloat16, device="cpu", int8=False)
    assert params["visual"]["blocks"][0]["attn"]["wqkv"].dtype == torch.bfloat16
    assert params["visual"]["blocks"][0]["ln_1"]["scale"].dtype == torch.float32
    images = _images(9, 4)
    with torch.no_grad():
        port = clip.encode_image(params, normalize_batch(images).bfloat16(), cfg).float()
    assert _rel_err(port, _reference(sd).encode_image(normalize_batch(images))) < BF16_TOL


# -- the normal path -----------------------------------------------------------------------------


def test_config_make_encode_fns_and_encode_loader(tiny):
    sd, path, _, _ = tiny
    run_cfg = Config(backbone=TINY_NAME, weights_path=path, batch_size=4, compute_dtype="float32")
    encode_images, encode_texts, cfg, _ = make_encode_fns(run_cfg, device="cpu", int8=False)
    assert cfg == TINY_CFG
    images = _images(10, 7).numpy()
    feats, labels = encode_loader(encode_images,
                                  ArrayLoader(images, np.arange(7, dtype=np.int32), batch_size=4))
    ref = _reference(sd)
    assert _rel_err(torch.from_numpy(feats),
                    ref.encode_image(normalize_batch(torch.from_numpy(images)))) < FP32_TOL
    np.testing.assert_array_equal(labels, np.arange(7))
    tokens = _tokens(11, 3)
    assert _rel_err(encode_texts(tokens.numpy()), ref.encode_text(tokens)) < FP32_TOL


def test_random_init_by_name():
    cfg = dataclasses.replace(TINY_CFG, vision_layers=1)
    params = clip.init_clip_params(np.random.default_rng(0), cfg)
    blk = params["visual"]["blocks"][0]
    assert blk["attn"]["wqkv"].shape == (64, 192) and blk["mlp"]["w_fc"].shape == (64, 480)
    assert not blk["attn"]["bqkv"].any()
    out = _encode(params, cfg, _images(12, 2))
    assert out.shape == (2, TINY["embed"]) and torch.isfinite(out).all()


def test_load_clip_by_name_without_weights(monkeypatch):
    seen = []
    monkeypatch.setattr(clip, "find_weights", lambda name: None)
    monkeypatch.setattr(clip, "init_clip_params",
                        lambda rng, cfg: seen.append(cfg) or {"logit_scale": torch.zeros(())})
    cfg, _ = clip.load_clip(BACKBONE, device="cpu", int8=False)
    assert cfg is clip.PORT_BACKBONE_CONFIGS[BACKBONE] and seen == [cfg]


# -- refusals -------------------------------------------------------------------------------------


def test_the_w8a8_mode_refuses_the_backbone(tiny, monkeypatch):
    _, path, cfg, params = tiny
    with pytest.raises(ValueError, match="K3"):
        clip.quantize_for_serving(params)
    with pytest.raises(ValueError, match="K3"):
        clip.load_clip(TINY_NAME, path, dtype=torch.float32, device="cpu", int8=True)
    with pytest.raises(ValueError, match="K3.*eva_postnorm"):
        clip.encode_image(params, normalize_batch(_images(15, 1)), cfg, int8=True)
    with pytest.raises(ValueError, match="K3"):
        clip.encode_text(params, _tokens(15, 1), cfg, int8=True)
    monkeypatch.setenv("PROTOCLIP_INT8", "1")
    with pytest.raises(ValueError, match="K3"):
        make_encode_fns(Config(backbone=TINY_NAME, weights_path=path, compute_dtype="float32"),
                        device="cpu")


def test_a_serving_bundle_refuses_the_backbone(tiny, tmp_path):
    from protoclip_tpu_torch.io.export import save_serving_bundle

    _, _, cfg, params = tiny
    with pytest.raises(ValueError, match="eva_postnorm"):
        save_serving_bundle(str(tmp_path / "bundle"), cfg, params, 4)
    assert not (tmp_path / "bundle").exists()


class _OnCard:
    """Stands in for an activation on the card (no CUDA here): the block
    must refuse its dtype before it reads anything else."""

    is_cuda = True

    def __init__(self, dtype):
        self.dtype = dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_the_block_refuses_other_dtypes_than_bf16_on_the_card(dtype):
    with pytest.raises(TypeError, match="bfloat16"):
        kernels.fused_eva_postnorm_block(_OnCard(dtype), {}, 2)


def test_launch_counters_name_the_new_kernel_and_block():
    assert {"layernorm_residual_rows", "fused_eva_postnorm_block"} <= set(kernels.LAUNCHES)
