"""protoclip_tpu_torch's ResNet towers against protoclip_tpu's, on the CPU.

The geometries are tests/test_resnet_parity.py's, plus its uneven
(3, 4, 2, 3) width-10 tower.  Each OpenAI-format state dict goes through the
JAX package's ``convert_clip_state_dict``/``encode_image`` and through the
port by both routes: its own conversion and ``params_from_jax``.

Bars: in fp32, ``max|diff| / max|ref| <= 1e-5`` and cosine >= 0.99999; in
bf16, a row cosine >= 0.999 (the two packages round the same values to bf16,
but their convolutions sum in different orders).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protoclip_tpu.models import clip as jclip
from protoclip_tpu.ops import pallas_kernels as pk

from protoclip_tpu_torch.models import clip, resnet
from tests.test_models import _tiny_torch_style_state_dict
from tests.test_resnet_parity import EMBED, GEOMETRIES, IMG, _rand_rn_state_dict
from tests.test_torch_models import GOLDENS, leaves, np_tree, port_config, tiny_tokens

ALL_GEOMETRIES = {**GEOMETRIES, "custom-uneven": (10, (3, 4, 2, 3))}


def jax_encode(jcfg):
    return jax.jit(lambda p, x: jclip.encode_image(p, x, jcfg))


def jax_init(jcfg):
    return jax.jit(lambda key: jclip.init_clip_params(key, jcfg))


def rel_err(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def cosine(out, ref):
    out, ref = np.asarray(out, np.float64).ravel(), np.asarray(ref, np.float64).ravel()
    return float(out @ ref / (np.linalg.norm(out) * np.linalg.norm(ref)))


def row_cosines(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return (out * ref).sum(-1) / (np.linalg.norm(out, axis=-1) * np.linalg.norm(ref, axis=-1))


@pytest.fixture(scope="module", params=sorted(ALL_GEOMETRIES))
def converted(request):
    """One geometry's state dict through both packages' conversions."""
    width, layers = ALL_GEOMETRIES[request.param]
    rng = np.random.default_rng(0)
    sd = _rand_rn_state_dict(rng, width, layers)
    jcfg, jparams = jclip.convert_clip_state_dict(sd)
    cfg, params = clip.convert_clip_state_dict(sd)
    images = rng.standard_normal((3, IMG, IMG, 3)).astype(np.float32)
    return sd, jcfg, jparams, cfg, params, images


def test_resnet_fp32_matches_jax_by_both_routes(converted):
    _, jcfg, jparams, cfg, params, images = converted
    assert cfg == port_config(jcfg) and not cfg.is_vit
    carried = clip.params_from_jax(np_tree(jparams), cfg, device="cpu")
    ours, theirs = dict(leaves(params)), dict(leaves(carried))
    assert ours.keys() == theirs.keys()
    for key in ours:  # HWIO -> OIHW and the un-stacked rest are exact
        assert torch.equal(ours[key], theirs[key]), key
    ref = np.asarray(jax_encode(jcfg)(jax.tree_util.tree_map(jnp.asarray, jparams),
                                      jnp.asarray(images)))
    for p in (params, carried):
        with torch.inference_mode():
            out = clip.encode_image(p, torch.from_numpy(images), cfg).numpy()
        assert out.shape == (3, EMBED)
        assert rel_err(out, ref) <= 1e-5 and cosine(out, ref) >= 0.99999


def test_resnet_bf16_matches_jax(converted):
    _, jcfg, jparams, cfg, params, images = converted
    jp = jclip.cast_params(jparams, jnp.bfloat16)
    ref = np.asarray(jax_encode(jcfg)(jp, jnp.asarray(images)).astype(jnp.float32))
    casted = clip.cast_params(params, torch.bfloat16)
    stem = casted["visual"]["stem"]
    assert stem["conv1"].dtype == torch.bfloat16 and stem["bn1"]["scale"].dtype == torch.float32
    block = casted["visual"]["layer1"][0]
    assert block["downsample"]["bn"]["bias"].dtype == torch.float32
    assert casted["visual"]["attnpool"]["wq"].dtype == torch.bfloat16
    with torch.inference_mode():
        out = clip.encode_image(casted, torch.from_numpy(images), cfg)
    assert out.dtype == torch.bfloat16
    assert row_cosines(out.float().numpy(), ref).min() >= 0.999


def test_layers_keep_channels_last(converted):
    """The tower permutes NHWC images into a channels_last NCHW view, and the
    convs, the folded BN and the stride-2 average pool keep that format."""
    _, _, _, cfg, params, images = converted
    x = torch.from_numpy(images).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    vis = params["visual"]
    stem = vis["stem"]
    assert stem["conv2"].is_contiguous(memory_format=torch.channels_last)
    steps = [lambda h: resnet.scale_bias(resnet.conv(h, stem["conv1"], stride=2, padding=1),
                                         stem["bn1"], relu=True),
             lambda h: resnet.scale_bias(resnet.conv(h, stem["conv2"], padding=1), stem["bn2"]),
             lambda h: resnet.scale_bias(resnet.conv(h, stem["conv3"], padding=1), stem["bn3"]),
             lambda h: resnet.avg_pool(h, 2)]
    steps += [lambda h, b=b: resnet.bottleneck(h, b, 1) for b in vis["layer1"]]
    steps += [lambda h: resnet.bottleneck(h, vis["layer2"][0], 2)]  # the stride-2 pools
    for step in steps:
        x = step(x)
        assert x.is_contiguous(memory_format=torch.channels_last), tuple(x.stride())


def test_infer_config_and_init_match_jax():
    width, layers = ALL_GEOMETRIES["custom-uneven"]
    sd = _rand_rn_state_dict(np.random.default_rng(1), width, layers)
    cfg = clip.infer_config_from_state_dict(sd)
    assert cfg == port_config(jclip.infer_config_from_state_dict(sd))
    assert (cfg.name, cfg.vision_layers, cfg.image_resolution) == ("custom", layers, IMG)
    assert cfg.vision_heads_resnet == 5

    # the port's seeded init has JAX's tree (after params_from_jax) and shapes
    jparams = np_tree(jax_init(port_config(cfg))(jax.random.PRNGKey(0)))
    carried = dict(leaves(clip.params_from_jax(jparams, cfg, device="cpu")))
    ours = clip.init_clip_params(np.random.default_rng(0), cfg)
    again = clip.init_clip_params(np.random.default_rng(0), cfg)
    assert {k: tuple(v.shape) for k, v in leaves(ours)} == \
        {k: tuple(v.shape) for k, v in carried.items()}
    for (key, a), (_, b) in zip(leaves(ours), leaves(again)):
        assert torch.equal(a, b), key


def test_golden_tiny_rn_reproduced():
    """The port, given the JAX package's ``init_clip_params(PRNGKey(
    20240817))`` weights, reproduces the ``synthetic:tiny-rn`` checksums of
    tests/goldens.json with the recipe of scripts/record_goldens.py:86-128,
    within test_golden.py's 2e-3."""
    with open(GOLDENS) as fh:
        want = json.load(fh)["synthetic:tiny-rn"]
    from scripts.record_goldens import synthetic_specs

    jcfg = synthetic_specs()["synthetic:tiny-rn"]
    cfg = port_config(jcfg)
    params = clip.params_from_jax(
        np_tree(jax_init(jcfg)(jax.random.PRNGKey(20240817))), cfg, device="cpu")
    rng = np.random.default_rng(0)
    res = cfg.image_resolution
    images = rng.integers(0, 256, (4, res, res, 3)).astype(np.float32) / 255.0
    tokens = np.zeros((4, cfg.context_length), np.int32)
    for row in range(4):
        length = 3 + row * 3
        tokens[row, : length - 1] = rng.integers(1, cfg.vocab_size - 1, length - 1)
        tokens[row, length - 1] = cfg.vocab_size - 1
    proj = torch.from_numpy(
        np.random.default_rng(1234).standard_normal(cfg.embed_dim).astype(np.float32))
    with torch.inference_mode():
        img = clip.encode_image(params, torch.from_numpy(images), cfg)
        txt = clip.encode_text(params, torch.from_numpy(tokens), cfg)
    img = img / img.norm(dim=-1, keepdim=True)
    txt = txt / txt.norm(dim=-1, keepdim=True)
    got = {"per_image_sums": img.sum(-1), "per_image_proj": img @ proj,
           "per_text_sums": txt.sum(-1), "per_text_proj": txt @ proj}
    assert set(got) == set(want)
    for key, values in got.items():
        np.testing.assert_allclose(values.numpy(), want[key], atol=2e-3, rtol=0, err_msg=key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_serving_quantizes_only_the_text_blocks(tmp_path, monkeypatch, dtype):
    """Under ``$PROTOCLIP_INT8`` an RN backbone's text tower gets its int8
    layers (held to JAX's ``quantize_stacked_blocks`` at the bars of
    tests/test_torch_int8.py::test_load_clip_quantizes_at_load_as_jax); the
    ResNet image tower passes through."""
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(2)
    sd = {k: v for k, v in _rand_rn_state_dict(rng, *GEOMETRIES["rn50-like"]).items()
          if k.startswith("visual.")}
    # a text tower of width 64 (one head) under the ResNet image tower
    sd.update({k: v for k, v in _tiny_torch_style_state_dict(rng).items()
               if not k.startswith("visual.")})
    path = tmp_path / "tiny_rn.pt"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    monkeypatch.setenv("PROTOCLIP_INT8", "1")
    cfg, params = clip.load_clip("tiny-rn", str(path), dtype=td, device="cpu")
    assert "blocks_q" not in params["visual"] and "layer1" in params["visual"]
    _, jparams = jclip.load_clip("tiny-rn", str(path), dtype=jd)  # Pallas off: not quantized
    ref = dict(leaves(clip._qblocks_from_jax(
        np_tree(jclip.quantize_for_serving(jparams))["text"]["blocks_q"])))
    with jax.disable_jit():
        eager = dict(leaves(clip._qblocks_from_jax(
            np_tree(pk.quantize_stacked_blocks(jparams["text"]["blocks"])))))
    ours = params["text"]["blocks_q"]
    assert len(ours) == cfg.transformer_layers
    for key, value in leaves(ours):
        assert torch.equal(value, eager[key]), key
        leaf = key.split("/")[-1]
        if leaf in ("sqkv", "so", "sfc", "sproj"):
            np.testing.assert_allclose(value.numpy(), ref[key].numpy(), rtol=1.2e-7, atol=0)
        elif leaf in ("wqkv", "wo", "wfc", "wproj"):
            step = np.abs(value.numpy().astype(np.int32) - ref[key].numpy())
            assert step.max() <= 1 and (step == 0).mean() >= 0.999, key
        else:
            assert torch.equal(value, ref[key]), key

    # the serving mode's encodes: the image tower in the load dtype, the
    # text tower on K3's plain version
    images = torch.from_numpy(np.random.default_rng(3).standard_normal((2, IMG, IMG, 3))
                              .astype(np.float32))
    tokens = torch.from_numpy(tiny_tokens(np.random.default_rng(4), 2, cfg.context_length,
                                          cfg.vocab_size))
    with torch.inference_mode():
        img = clip.encode_image(params, images, cfg)
        txt = clip.encode_text(params, tokens, cfg)
    assert img.dtype == td and img.shape == (2, EMBED) and bool(torch.isfinite(img).all())
    assert txt.shape == (2, EMBED) and bool(torch.isfinite(txt.float()).all())


def test_load_clip_random_init_builds_rn50(monkeypatch, tmp_path):
    monkeypatch.setenv("PROTOCLIP_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path))
    cfg, params = clip.load_clip("RN50", dtype=torch.bfloat16, device="cpu", seed=0)
    vis = params["visual"]
    assert cfg == clip.BACKBONE_CONFIGS["RN50"]
    assert [len(vis[f"layer{i}"]) for i in range(1, 5)] == [3, 4, 6, 3]
    assert vis["layer4"][0]["conv3"].shape == (2048, 512, 1, 1)
    assert vis["layer4"][0]["conv3"].dtype == torch.bfloat16
    assert vis["layer4"][0]["bn3"]["scale"].dtype == torch.float32
    assert vis["attnpool"]["positional_embedding"].shape == (50, 2048)
    assert vis["attnpool"]["wo"].shape == (2048, 1024)
    with torch.inference_mode():
        out = clip.encode_image(params, torch.zeros(1, 224, 224, 3, dtype=torch.bfloat16), cfg)
    assert out.shape == (1, 1024) and bool(torch.isfinite(out.float()).all())


def jax_resnet_tree(visual):
    """The port's ResNet tower -> the JAX package's: OIHW -> HWIO, each
    layer's list -> ``block0`` and a stacked ``rest``."""
    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                v.float().numpy().transpose(2, 3, 1, 0) if k.startswith("conv") else
                v.float().numpy() for k, v in tree.items()}

    out = {"stem": walk(visual["stem"]), "attnpool": walk(visual["attnpool"])}
    for i in range(1, 5):
        blocks = [walk(b) for b in visual[f"layer{i}"]]
        rest = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *blocks[1:]) if blocks[1:] else None
        out[f"layer{i}"] = {"block0": blocks[0], "rest": rest}
    return out


def test_rn50_full_width_matches_jax():
    """RN50's image tower at full width (224 px, 3-4-6-3, width 64) on the
    port's seeded init, carried into the JAX package: fp32 at the fp32 bar,
    and bf16 at the bf16 bar with the residual branches damped (every bn3
    scale x 0.25, as chip_smoke.py's runner phase holds the card): the
    undamped init doubles the activations' variance at every residual add,
    and its attention pool is close to an argmax that bf16 rounding moves."""
    from protoclip_tpu.data.transforms import normalize_batch as jax_normalize
    from protoclip_tpu_torch.data import normalize_batch

    cfg = clip.BACKBONE_CONFIGS["RN50"]
    visual = resnet.init_resnet_params(np.random.default_rng(0), cfg)
    images = np.random.default_rng(1).integers(0, 256, (2, 224, 224, 3), dtype=np.uint8)
    encode = jax_encode(jclip.BACKBONE_CONFIGS["RN50"])

    def both(vis, dtype, jdtype):
        port = {"visual": vis}
        with torch.inference_mode():
            ours = clip.encode_image(clip.cast_params(port, dtype),
                                     normalize_batch(torch.from_numpy(images), dtype), cfg)
        ref = encode(jclip.cast_params({"visual": jax_resnet_tree(vis)}, jdtype),
                     jax_normalize(jnp.asarray(images), jdtype))
        return ours.float().numpy(), np.asarray(ref.astype(jnp.float32))

    ours, ref = both(visual, torch.float32, jnp.float32)
    assert rel_err(ours, ref) <= 1e-5 and cosine(ours, ref) >= 0.99999
    damped = {**visual, **{f"layer{i}": [{**b, "bn3": {"scale": b["bn3"]["scale"] * 0.25,
                                                      "bias": b["bn3"]["bias"]}}
                                         for b in visual[f"layer{i}"]] for i in range(1, 5)}}
    ref32 = both(damped, torch.float32, jnp.float32)[1]
    ours, ref = both(damped, torch.bfloat16, jnp.bfloat16)
    assert row_cosines(ours, ref32).min() >= 0.999 and row_cosines(ref, ref32).min() >= 0.999
