"""EVA02-CLIP-L/14-336 on the port, on the CPU: the EVA02 image tower and
the exact-GELU text tower against the plain fp32 reference
(``tests/eva_reference.py``), EVA-CLIP's state-dict layout through the
normal entry points, the RoPE tables, the sub-LN over a padded row and
the W8A8 mode's refusal.

Tiny geometry: width 128, 2 heads of 64, 2 layers, 56 px at patch 14
(a 4 x 4 grid, so the RoPE tables interpolate 16 -> 4), SwiGLU hidden
int(128 * 2.6667) = 341, padded to 344; text 64 wide, 1 head, 1 layer.

Tolerances (each the worst row's ``|port - ref| / |ref|``):

- ``FP32_TOL`` 1e-5: the port's plain versions in fp32 against the
  reference differ only in the order of fp32 sums (~1e-6 at these
  sizes), while one bf16 rounding of the RoPE output or of the SwiGLU
  hidden moves the features by more than 1e-4
  (:func:`test_fp32_tolerance_sees_a_bf16_rounding`);
- ``BF16_TOL`` 3e-2: the bf16 path rounds every activation (2^-9 each)
  through 2 blocks.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from protoclip_tpu_torch.core.config import Config
from protoclip_tpu_torch.data.loader import ArrayLoader
from protoclip_tpu_torch.data.transforms import normalize_batch
from protoclip_tpu_torch.memory.banks import encode_loader
from protoclip_tpu_torch.models import clip, eva
from protoclip_tpu_torch.ops import kernels
from protoclip_tpu_torch.train.runner import make_encode_fns
from tests.eva_reference import TINY, EvaCLIP, _normal, eva_state_dict, rope_tables

FP32_TOL = 1e-5
BF16_TOL = 3e-2
BACKBONE = "EVA02-CLIP-L-14-336"
def _reference(sd, t=TINY, act="gelu"):
    return EvaCLIP(sd, t["heads"], t["text_heads"], eva.DEFAULT_PT_GRID, act)


def _rel_err(got, ref):
    got, ref = got.double(), ref.double()
    return float(((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max())


def _tokens(seed, n, t=TINY):
    rng = np.random.default_rng(seed)
    tok = np.zeros((n, t["context"]), np.int64)
    for i in range(n):
        length = int(rng.integers(3, t["context"]))
        tok[i, :length] = rng.integers(1, t["vocab"] - 1, length)
        tok[i, length - 1] = t["vocab"] - 1  # EOT: the largest id
    return torch.from_numpy(tok)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The synthetic state dict, its file, and the port's fp32 load of it."""
    sd = eva_state_dict(0)
    path = str(tmp_path_factory.mktemp("eva") / "eva02_tiny.pt")
    torch.save(sd, path)
    cfg, params = clip.load_clip(BACKBONE, path, dtype=torch.float32, device="cpu", int8=False)
    return sd, path, cfg, params


def _images(seed, n, px=TINY["px"]):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (n, px, px, 3),
                                                                 dtype=np.uint8))


# -- registry and layout --------------------------------------------------------------------


def test_the_port_registry_is_kept_apart():
    cfg = clip.backbone_config(BACKBONE)
    assert cfg is clip.PORT_BACKBONE_CONFIGS[BACKBONE]
    assert BACKBONE not in clip.BACKBONE_CONFIGS and BACKBONE not in clip.available_backbones()
    assert (cfg.vision_width, cfg.vision_layers, cfg.vision_heads, cfg.vision_patch_size,
            cfg.image_resolution, cfg.vision_mlp_width, cfg.rope_pt_grid) == (
        1024, 24, 16, 14, 336, int(1024 * 2.6667), 16)
    assert (cfg.transformer_width, cfg.transformer_heads, cfg.transformer_layers,
            cfg.embed_dim, cfg.context_length, cfg.vocab_size, cfg.text_act) == (
        768, 12, 12, 768, 77, 49408, "gelu")
    assert eva.padded_hidden(2730) == 2736 and eva.padded_hidden(341) == 344


def test_the_layout_is_inferred_and_converted(tiny):
    sd, _, cfg, params = tiny
    assert cfg.is_eva and cfg.name == "custom" and cfg.rope_pt_grid == eva.DEFAULT_PT_GRID
    assert (cfg.vision_width, cfg.vision_layers, cfg.image_resolution, cfg.vision_mlp_width,
            cfg.embed_dim, cfg.transformer_width, cfg.transformer_layers) == (
        128, 2, 56, 341, 32, 64, 1)
    blk = params["visual"]["blocks"][1]
    w, h = 128, 341
    # the fused QKV with k's bias 0; w1 and w2 interleaved, padded to 344
    np.testing.assert_array_equal(blk["attn"]["wqkv"][:, w:2 * w],
                                  sd["visual.blocks.1.attn.k_proj.weight"].T)
    np.testing.assert_array_equal(blk["attn"]["bqkv"][w:2 * w], np.zeros(w))
    np.testing.assert_array_equal(blk["attn"]["bqkv"][2 * w:], sd["visual.blocks.1.attn.v_bias"])
    w12, b12 = blk["mlp"]["w12"], blk["mlp"]["b12"]
    assert w12.shape == (w, 2 * 344) and blk["mlp"]["w3"].shape == (344, w)
    np.testing.assert_array_equal(w12[:, 1:2 * h:2], sd["visual.blocks.1.mlp.w2.weight"].T)
    np.testing.assert_array_equal(b12[0:2 * h:2], sd["visual.blocks.1.mlp.w1.bias"])
    assert not w12[:, 2 * h:].any() and not b12[2 * h:].any() and not blk["mlp"]["w3"][h:].any()
    assert blk["mlp"]["ln_ffn"]["scale"].shape == (h,)
    # the registered backbone's shapes name it, and give its RoPE grid
    shapes = {"visual.patch_embed.proj.weight": (1024, 3, 14, 14),
              "visual.pos_embed": (1, 577, 1024), "visual.blocks.0.mlp.w1.weight": (2730, 1024),
              "visual.head.weight": (768, 1024), "text.positional_embedding": (77, 768),
              "text.token_embedding.weight": (49408, 768), "text.ln_final.weight": (768,),
              "visual.blocks.0.attn.q_proj.weight": (1,), "visual.blocks.0.mlp.w3.weight": (1,)}
    shapes.update({f"visual.blocks.{i}.norm1.weight": (1,) for i in range(24)})
    shapes.update({f"text.transformer.resblocks.{i}.ln_1.weight": (1,) for i in range(12)})
    named = clip.infer_config_from_state_dict({k: np.zeros(s) for k, s in shapes.items()})
    assert named == clip.PORT_BACKBONE_CONFIGS[BACKBONE]


def test_a_wrong_rope_buffer_is_refused(tmp_path):
    sd = eva_state_dict(1)
    sd["visual.blocks.1.attn.rope.freqs_sin"] = sd["visual.blocks.1.attn.rope.freqs_sin"] + 1e-3
    with pytest.raises(ValueError, match="freqs_sin"):
        clip.convert_clip_state_dict(sd)


# -- RoPE -----------------------------------------------------------------------------------


@pytest.mark.parametrize("grid,pt_grid", [(24, 16), (16, 16), (4, 16)])
def test_rope_tables_match_the_closed_form(grid, pt_grid):
    cos, sin = eva.rope_tables(grid, pt_grid, 64)
    assert cos.shape == (grid * grid, 64) and cos.dtype == torch.float32
    # closed form at one cell: channels 2i, 2i+1 of the first half turn at
    # r * pt / grid * 10000^(-2i / 32), of the second at c * pt / grid * ...
    r, c = grid - 1, grid // 3
    i = np.arange(16)
    ang = np.concatenate([np.repeat(r * pt_grid / grid * 10000.0 ** (-2 * i / 32), 2),
                          np.repeat(c * pt_grid / grid * 10000.0 ** (-2 * i / 32), 2)])
    # fp32 angles up to 23 * 16 / 24 rad: a few ulps of the angle
    np.testing.assert_allclose(cos[r * grid + c].numpy(), np.cos(ang), rtol=0, atol=2e-6)
    np.testing.assert_allclose(sin[r * grid + c].numpy(), np.sin(ang), rtol=0, atol=2e-6)
    ref_cos, ref_sin = rope_tables(grid, pt_grid, 64)
    np.testing.assert_allclose(cos.numpy(), ref_cos.numpy(), rtol=0, atol=2e-6)
    np.testing.assert_allclose(sin.numpy(), ref_sin.numpy(), rtol=0, atol=2e-6)


def test_rope_turns_q_and_k_of_the_patch_tokens_only():
    g = torch.Generator().manual_seed(3)
    l, d, dh = 17, 128, 64
    a, w, b = _normal(g, 2, l, d), _normal(g, d, 3 * d, std=d ** -0.5), _normal(g, 3 * d)
    cos, sin = eva.rope_tables(4, 16, dh)
    out = kernels.gemm_bias_rope_plain(a, w, b, cos, sin, 2 * d)
    plain = a @ w + b
    # the class token and v come out as the biased product
    torch.testing.assert_close(out[:, 0], plain[:, 0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(out[..., 2 * d:], plain[..., 2 * d:], rtol=1e-6, atol=1e-6)
    # a patch token's head: interleaved pairs turned by its angle
    t = plain[1, 5, d + dh:d + 2 * dh]  # token 5, k of head 1
    c, s = cos[4], sin[4]
    want = torch.stack([t[0::2] * c[0::2] - t[1::2] * s[0::2],
                        t[1::2] * c[1::2] + t[0::2] * s[1::2]], -1).flatten()
    torch.testing.assert_close(out[1, 5, d + dh:d + 2 * dh], want, rtol=1e-5, atol=1e-5)


# -- the sub-LN and the epilogues ----------------------------------------------------------


def test_ln_ffn_statistics_cover_the_valid_width_only():
    g = torch.Generator().manual_seed(4)
    w, stride = 341, 344
    x = _normal(g, 5, stride)
    x[:, w:] = 1e3  # the padded lanes hold anything; they must not count
    scale, bias = 1 + _normal(g, w, std=0.1), _normal(g, w, std=0.1)
    out = kernels.layernorm_sub_rows(x, scale, bias)
    ref = torch.nn.functional.layer_norm(x[:, :w], (w,), scale, bias, kernels.EVA_LN_EPS)
    torch.testing.assert_close(out[:, :w], ref, rtol=1e-5, atol=1e-5)
    assert not out[:, w:].any()
    # statistics over all 344 lanes would be far off
    wrong = torch.nn.functional.layer_norm(x, (stride,), eps=kernels.EVA_LN_EPS)[:, :w]
    assert (wrong * scale + bias - ref).abs().max() > 0.1


def test_swiglu_epilogue_is_silu_gate_times_value():
    g = torch.Generator().manual_seed(5)
    sd = eva_state_dict(5)
    cfg = clip.infer_config_from_state_dict(sd)
    blk = eva.visual_from_state_dict({k: v.numpy() for k, v in sd.items()}, cfg)["blocks"][0]
    x = _normal(g, 3, 7, 128)
    out = kernels.gemm_bias_swiglu_plain(x, blk["mlp"]["w12"], blk["mlp"]["b12"])
    m = "visual.blocks.0.mlp."
    want = (torch.nn.functional.silu(x @ sd[m + "w1.weight"].T + sd[m + "w1.bias"])
            * (x @ sd[m + "w2.weight"].T + sd[m + "w2.bias"]))
    assert out.shape == (3, 7, 344) and not out[..., 341:].any()
    torch.testing.assert_close(out[..., :341], want, rtol=1e-5, atol=1e-5)


def test_exact_gelu_epilogue():
    g = torch.Generator().manual_seed(6)
    a, w, b = _normal(g, 9, 64), _normal(g, 64, 256, std=0.125), _normal(g, 256)
    out = kernels.gemm_bias_epilogue_plain(a, w, b, "bias_gelu_erf")
    torch.testing.assert_close(out, torch.nn.functional.gelu(a @ w + b), rtol=1e-5, atol=1e-5)
    tanh = torch.nn.functional.gelu(a @ w + b, approximate="tanh")
    assert (out - tanh).abs().max() > 1e-5  # the tanh form is another function


# -- the towers against the reference ----------------------------------------------------------


def test_image_tower_matches_the_reference_in_fp32(tiny):
    sd, _, cfg, params = tiny
    images = normalize_batch(_images(7, 4))
    with torch.no_grad():
        port = clip.encode_image(params, images, cfg)
    assert _rel_err(port, _reference(sd).encode_image(images)) < FP32_TOL


def test_text_tower_matches_the_reference_in_fp32(tiny):
    sd, _, cfg, params = tiny
    tokens = _tokens(8, 5)
    with torch.no_grad():
        port = clip.encode_text(params, tokens, cfg)
    ref = _reference(sd)
    assert _rel_err(port, ref.encode_text(tokens)) < FP32_TOL
    # QuickGELU in its place is another tower
    assert _rel_err(port, _reference(sd, act="quick_gelu").encode_text(tokens)) > 100 * FP32_TOL


@pytest.mark.parametrize("where", ["rope", "swiglu"])
def test_fp32_tolerance_sees_a_bf16_rounding(tiny, monkeypatch, where):
    """Rounding the RoPE output or the SwiGLU hidden to bf16 in an fp32 run
    fails FP32_TOL: the tolerance is tight enough to see that precision."""
    sd, _, cfg, params = tiny
    name = {"rope": "gemm_bias_rope_plain", "swiglu": "gemm_bias_swiglu_plain"}[where]
    exact = getattr(kernels, name)
    monkeypatch.setattr(kernels, name, lambda *a: exact(*a).bfloat16().float())
    images = normalize_batch(_images(7, 4))
    with torch.no_grad():
        port = clip.encode_image(params, images, cfg)
    assert _rel_err(port, _reference(sd).encode_image(images)) > FP32_TOL


def test_image_tower_in_bf16(tiny):
    sd, path, _, _ = tiny
    cfg, params = clip.load_clip(BACKBONE, path, dtype=torch.bfloat16, device="cpu", int8=False)
    images = normalize_batch(_images(9, 4))
    with torch.no_grad():
        port = clip.encode_image(params, images.bfloat16(), cfg).float()
    assert _rel_err(port, _reference(sd).encode_image(images)) < BF16_TOL


# -- the normal path -----------------------------------------------------------------------------


def test_config_make_encode_fns_and_encode_loader(tiny):
    sd, path, _, _ = tiny
    run_cfg = Config(backbone=BACKBONE, weights_path=path, batch_size=4, compute_dtype="float32")
    encode_images, encode_texts, cfg, _ = make_encode_fns(run_cfg, device="cpu", int8=False)
    assert cfg.is_eva
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
    cfg = dataclasses.replace(clip.PORT_BACKBONE_CONFIGS[BACKBONE], image_resolution=56,
                              vision_layers=1, vision_width=128, vision_mlp_width=341,
                              transformer_layers=1, transformer_width=64, vocab_size=300,
                              context_length=16, embed_dim=32)
    params = clip.init_clip_params(np.random.default_rng(0), cfg)
    assert params["visual"]["blocks"][0]["mlp"]["w12"].shape == (128, 688)
    with torch.no_grad():
        out = clip.encode_image(params, normalize_batch(_images(12, 2)), cfg)
    assert out.shape == (2, 32) and torch.isfinite(out).all()


def test_load_clip_by_name_without_weights(monkeypatch):
    """No weights file: the port's registry gives the architecture (the
    draw itself is held at the tiny size above)."""
    seen = []
    monkeypatch.setattr(clip, "find_weights", lambda name: None)
    monkeypatch.setattr(clip, "init_clip_params",
                        lambda rng, cfg: seen.append(cfg) or {"logit_scale": torch.zeros(())})
    cfg, _ = clip.load_clip(BACKBONE, device="cpu", int8=False)
    assert cfg is clip.PORT_BACKBONE_CONFIGS[BACKBONE] and seen == [cfg]


def test_the_classifier_runs_the_backbone(tiny, tmp_path):
    from protoclip_tpu_torch.toolkit.classifier import ProtoClipClassifier

    sd, path, _, _ = tiny
    rng = np.random.default_rng(13)
    d, n_class, k = TINY["embed"], 3, 2
    paths = {n: str(tmp_path / f"{n}.pt") for n in ("v", "t", "a")}
    for name, rows in (("v", n_class * k), ("t", n_class)):
        torch.save(torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32)), paths[name])
    torch.save({"fc.0.weight": torch.randn(d // 4, d), "fc.1.weight": torch.ones(d // 4),
                "fc.1.bias": torch.zeros(d // 4), "fc.2.weight": torch.randn(d, d // 4),
                "fc.3.weight": torch.ones(d), "fc.3.bias": torch.zeros(d)}, paths["a"])
    splits = tmp_path / "splits.json"
    splits.write_text(json.dumps({"train": [["a.png", c, f"object_{c}"] for c in range(n_class)]}))
    cfg = Config(dataset="fewsol", shots=k, backbone=BACKBONE, weights_path=path, alpha=0.5,
                 beta=5.0, adapter="fc", top_k=2, compute_dtype="float32")
    clf = ProtoClipClassifier(cfg, splits_path=str(splits), memory_bank_v_path=paths["v"],
                              memory_bank_t_path=paths["t"], adapter_weights_path=paths["a"],
                              max_batch=4, device="cpu")
    assert clf.clip_cfg.is_eva
    canvases = _images(14, 3)
    feats = clf._encode(canvases)
    ref = _reference(sd).encode_image(normalize_batch(canvases))
    assert _rel_err(feats, ref / ref.norm(dim=-1, keepdim=True)) < FP32_TOL
    probs, ids = clf.infer_canvases(canvases.numpy())
    assert ids.shape == (3, 2) and np.all((ids >= 0) & (ids < n_class))


# -- K3 ---------------------------------------------------------------------------------------


def test_the_w8a8_mode_refuses_the_backbone(tiny, monkeypatch):
    _, path, cfg, params = tiny
    with pytest.raises(ValueError, match="K3"):
        clip.quantize_for_serving(params)
    with pytest.raises(ValueError, match="K3"):
        clip.load_clip(BACKBONE, path, dtype=torch.float32, device="cpu", int8=True)
    with pytest.raises(ValueError, match="K3"):
        clip.encode_image(params, normalize_batch(_images(15, 1)), cfg, int8=True)
    with pytest.raises(ValueError, match="K3"):
        clip.encode_text(params, _tokens(15, 1), cfg, int8=True)
    monkeypatch.setenv("PROTOCLIP_INT8", "1")
    with pytest.raises(ValueError, match="K3"):
        make_encode_fns(Config(backbone=BACKBONE, weights_path=path, compute_dtype="float32"),
                        device="cpu")


def test_a_serving_bundle_refuses_the_backbone(tiny, tmp_path):
    from protoclip_tpu_torch.io.export import save_serving_bundle

    _, _, cfg, params = tiny
    with pytest.raises(ValueError, match="EVA02"):
        save_serving_bundle(str(tmp_path / "bundle"), cfg, params, 4)
    assert not (tmp_path / "bundle").exists()


def test_launch_counters_name_every_new_kernel_and_mode():
    for name in ("layernorm_sub_rows", "gemm_bias_epilogue.bias_rope",
                 "gemm_bias_epilogue.bias_swiglu", "gemm_bias_epilogue.bias_gelu_erf",
                 "fused_eva_block"):
        assert name in kernels.LAUNCHES
