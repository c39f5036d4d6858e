"""protoclip_tpu_torch.models against protoclip_tpu.models, on the CPU.

Parameters are made by the JAX package and carried across with
``params_from_jax``, so both towers run the same weights; on the CPU the
port's transformer runs K2's plain version.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protoclip_tpu.models import adapters as jadapters
from protoclip_tpu.models import clip as jclip
from protoclip_tpu.models.layers import init_block_params as jax_init_block_params
from protoclip_tpu.models.layers import transformer as jax_transformer
from protoclip_tpu.models.vit import patchify as jax_patchify

from protoclip_tpu_torch.models import adapters, clip
from protoclip_tpu_torch.models.clip import _blocks_from_jax
from protoclip_tpu_torch.models.layers import transformer
from protoclip_tpu_torch.models.vit import patchify
from tests.test_models import TINY_VIT, _tiny_torch_style_state_dict

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens.json")


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_config(cfg):
    """The port's CLIPConfig with the same fields as a JAX one."""
    return clip.CLIPConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def tiny_tokens(rng, n, ctx, vocab):
    """Token rows in the golden recipe's shape: ids < EOT, EOT = max id."""
    tokens = np.zeros((n, ctx), np.int32)
    for row in range(n):
        length = 3 + 2 * row
        tokens[row, :length - 1] = rng.integers(1, vocab - 1, length - 1)
        tokens[row, length - 1] = vocab - 1
    return tokens


@pytest.fixture(scope="module")
def tiny():
    """TINY_VIT parameters from the JAX package and their port copy."""
    jparams = jclip.init_clip_params(jax.random.PRNGKey(0), TINY_VIT)
    cfg = port_config(TINY_VIT)
    return jparams, cfg, clip.params_from_jax(np_tree(jparams), cfg, device="cpu")


def test_patchify_matches_jax(rng):
    img = rng.standard_normal((2, 8, 12, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        patchify(torch.from_numpy(img), 4).numpy(), np.asarray(jax_patchify(jnp.asarray(img), 4))
    )


def test_registry_matches_jax():
    assert list(clip.BACKBONE_CONFIGS) == list(jclip.BACKBONE_CONFIGS)
    for name, cfg in jclip.BACKBONE_CONFIGS.items():
        assert port_config(cfg) == clip.BACKBONE_CONFIGS[name]
        ours = clip.BACKBONE_CONFIGS[name]
        assert (ours.vision_heads, ours.transformer_heads) == (cfg.vision_heads, cfg.transformer_heads)


def test_encode_image_and_text_match_jax(tiny, rng):
    jparams, cfg, params = tiny
    images = (rng.standard_normal((3, 32, 32, 3)) * 0.5).astype(np.float32)
    tokens = tiny_tokens(rng, 3, TINY_VIT.context_length, TINY_VIT.vocab_size)
    with torch.inference_mode():
        img = clip.encode_image(params, torch.from_numpy(images), cfg).numpy()
        txt = clip.encode_text(params, torch.from_numpy(tokens), cfg).numpy()
    np.testing.assert_allclose(
        img, np.asarray(jclip.encode_image(jparams, jnp.asarray(images), TINY_VIT)), atol=1e-4
    )
    np.testing.assert_allclose(
        txt, np.asarray(jclip.encode_text(jparams, jnp.asarray(tokens), TINY_VIT)), atol=1e-4
    )


def test_clip_forward_matches_jax(tiny, rng):
    jparams, cfg, params = tiny
    images = (rng.standard_normal((2, 32, 32, 3)) * 0.5).astype(np.float32)
    tokens = tiny_tokens(rng, 3, TINY_VIT.context_length, TINY_VIT.vocab_size)
    ours = clip.clip_forward(params, torch.from_numpy(images), torch.from_numpy(tokens), cfg)
    ref = jclip.clip_forward(jparams, jnp.asarray(images), jnp.asarray(tokens), TINY_VIT)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-3)


def test_text_eot_gather(tiny):
    _, cfg, params = tiny
    tokens = np.zeros((2, 16), dtype=np.int32)
    tokens[0, :4] = [126, 5, 7, 127]
    tokens[1, :7] = [126, 5, 7, 9, 11, 2, 127]
    out = clip.encode_text(params, torch.from_numpy(tokens), cfg)
    tokens2 = tokens.copy()
    tokens2[0, 5] = 3  # a stray token after EOT changes nothing (causal + EOT gather)
    out2 = clip.encode_text(params, torch.from_numpy(tokens2), cfg)
    np.testing.assert_allclose(out[0].numpy(), out2[0].numpy(), atol=1e-5)


def test_text_refuses_ids_that_jax_clamps(tiny, rng):
    """Ids past the tiny vocab, as the banks' EOT padding at CLIP's id 49407
    gives them: the port clamps them to the last row, as JAX's gather does,
    and takes the EOT position at the argmax of the ids as given, so its
    encode_text equals JAX's (the name predates the repair: the port used
    to raise here)."""
    jparams, cfg, params = tiny
    tokens = tiny_tokens(rng, 3, TINY_VIT.context_length, TINY_VIT.vocab_size)
    tokens[1] = 49407
    tokens[2, 8] = TINY_VIT.vocab_size + 5  # a stray id past the table after row 2's EOT
    clamped = np.minimum(tokens, TINY_VIT.vocab_size - 1)
    # the EOT position is the argmax of the ids as given, not of the clamped ones
    assert np.argmax(tokens[2]) == 8 and np.argmax(clamped[2]) == 6
    want = np.asarray(jclip.encode_text(jparams, jnp.asarray(tokens), TINY_VIT))
    got = clip.encode_text(params, torch.from_numpy(tokens), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_transformer_with_explicit_mask_matches_jax(rng):
    """An explicit additive mask takes residual_block instead of K2."""
    D, H, L, B, layers = 64, 4, 10, 2, 2
    stacked = jax_init_block_params(jax.random.PRNGKey(3), layers, D)
    blocks = _blocks_from_jax(np_tree(stacked))
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    mask = np.zeros((L, L), np.float32)
    mask[:, -2:] = -np.inf
    for m, causal in ((None, False), (mask, False), (mask, True)):
        ours = transformer(torch.from_numpy(x), blocks, H,
                           None if m is None else torch.from_numpy(m), causal=causal)
        ref = jax_transformer(jnp.asarray(x), stacked, H,
                              None if m is None else jnp.asarray(m), causal=causal)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)


def test_convert_clip_state_dict_matches_jax(rng):
    sd = _tiny_torch_style_state_dict(rng)
    jcfg, jparams = jclip.convert_clip_state_dict(sd)
    cfg, params = clip.convert_clip_state_dict(sd)
    assert cfg == port_config(jcfg)
    carried = clip.params_from_jax(np_tree(jparams), cfg, device="cpu")
    ours, theirs = dict(leaves(params)), dict(leaves(carried))
    assert ours.keys() == theirs.keys()
    for key in ours:
        assert torch.equal(ours[key], theirs[key]), key

    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    tokens = tiny_tokens(rng, 2, 16, 128)
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    np.testing.assert_allclose(
        clip.encode_image(params, torch.from_numpy(images), cfg).numpy(),
        np.asarray(jclip.encode_image(jp, jnp.asarray(images), jcfg)), atol=1e-4,
    )
    np.testing.assert_allclose(
        clip.encode_text(params, torch.from_numpy(tokens), cfg).numpy(),
        np.asarray(jclip.encode_text(jp, jnp.asarray(tokens), jcfg)), atol=1e-4,
    )


def test_infer_config_matches_jax_and_resnet_is_queued(rng):
    """Both tower kinds infer as in JAX; the ResNet towers, once queued,
    are ported (tests/test_torch_resnet.py holds them to JAX)."""
    from tests.test_resnet_parity import _rand_rn_state_dict

    for sd in (_tiny_torch_style_state_dict(rng), _rand_rn_state_dict(rng, 10, (3, 4, 2, 3))):
        cfg = clip.infer_config_from_state_dict(sd)
        assert cfg == port_config(jclip.infer_config_from_state_dict(sd))
    assert cfg.vision_patch_size is None and cfg.vision_layers == (3, 4, 2, 3)


def test_golden_tiny_vit_reproduced():
    """The port, given the JAX package's ``init_clip_params(PRNGKey(
    20240817))`` weights, reproduces the ``synthetic:tiny-vit`` checksums
    of tests/goldens.json with the recipe of
    scripts/record_goldens.py:86-128 at its 5-decimal rounding."""
    with open(GOLDENS) as fh:
        want = json.load(fh)["synthetic:tiny-vit"]
    from scripts.record_goldens import synthetic_specs

    jcfg = synthetic_specs()["synthetic:tiny-vit"]
    cfg = port_config(jcfg)
    params = clip.params_from_jax(
        np_tree(jclip.init_clip_params(jax.random.PRNGKey(20240817), jcfg)), cfg, device="cpu"
    )
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (4, 32, 32, 3)).astype(np.float32) / 255.0
    tokens = np.zeros((4, cfg.context_length), np.int32)
    for row in range(4):
        length = 3 + row * 3
        tokens[row, : length - 1] = rng.integers(1, cfg.vocab_size - 1, length - 1)
        tokens[row, length - 1] = cfg.vocab_size - 1
    proj = torch.from_numpy(
        np.random.default_rng(1234).standard_normal(cfg.embed_dim).astype(np.float32)
    )
    with torch.inference_mode():
        img = clip.encode_image(params, torch.from_numpy(images), cfg)
        txt = clip.encode_text(params, torch.from_numpy(tokens), cfg)
    img = img / img.norm(dim=-1, keepdim=True)
    txt = txt / txt.norm(dim=-1, keepdim=True)
    got = {
        "per_image_sums": img.sum(-1), "per_image_proj": img @ proj,
        "per_text_sums": txt.sum(-1), "per_text_proj": txt @ proj,
    }
    assert set(got) == set(want)
    for key, values in got.items():
        rounded = [round(float(v), 5) for v in values]
        # equal at the recorded 5 decimals, up to one unit in the last place
        np.testing.assert_allclose(rounded, want[key], atol=1.5e-5, rtol=0, err_msg=key)


def test_cast_params_contract(tiny):
    _, cfg, params = tiny
    casted = clip.cast_params(params, torch.bfloat16)
    vis = casted["visual"]
    assert vis["blocks"][0]["attn"]["wqkv"].dtype == torch.bfloat16
    assert vis["blocks"][1]["mlp"]["w_fc"].dtype == torch.bfloat16
    assert vis["patch_embed"].dtype == torch.bfloat16 and vis["proj"].dtype == torch.bfloat16
    assert vis["blocks"][0]["ln_1"]["scale"].dtype == torch.float32
    assert vis["blocks"][1]["ln_2"]["bias"].dtype == torch.float32
    assert vis["ln_pre"]["scale"].dtype == torch.float32
    assert vis["ln_post"]["scale"].dtype == torch.float32
    assert casted["text"]["ln_final"]["scale"].dtype == torch.float32
    assert casted["logit_scale"].dtype == torch.float32

    images = torch.from_numpy(
        (np.random.default_rng(0).standard_normal((2, 32, 32, 3)) * 0.4).astype(np.float32)
    )
    f32 = clip.encode_image(params, images, cfg)
    bf16 = clip.encode_image(casted, images.to(torch.bfloat16), cfg).float()
    cos = torch.nn.functional.cosine_similarity(f32, bf16, dim=-1)
    assert float(cos.min()) > 0.98


def test_load_clip_state_dict_file_and_random_init(tmp_path, rng, monkeypatch, capsys):
    sd = _tiny_torch_style_state_dict(rng)
    path = tmp_path / "tiny.pt"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    cfg, params = clip.load_clip("tiny", weights_path=str(path), dtype=torch.float32, device="cpu")
    ref_cfg, ref = clip.convert_clip_state_dict(sd)
    assert cfg == ref_cfg
    for (key, a), (_, b) in zip(leaves(params), leaves(ref)):
        assert torch.equal(a, b), key

    monkeypatch.setenv("PROTOCLIP_WEIGHTS_DIR", str(tmp_path / "none"))
    monkeypatch.setenv("HOME", str(tmp_path))
    cfg, params = clip.load_clip("ViT-B/32", dtype=torch.bfloat16, device="cpu", seed=1)
    assert "random initialization" in capsys.readouterr().err
    assert cfg == clip.BACKBONE_CONFIGS["ViT-B/32"]
    assert len(params["visual"]["blocks"]) == 12 and len(params["text"]["blocks"]) == 12
    assert params["visual"]["blocks"][0]["attn"]["wqkv"].shape == (768, 3 * 768)
    assert params["visual"]["blocks"][0]["attn"]["wqkv"].dtype == torch.bfloat16
    assert params["text"]["ln_final"]["scale"].dtype == torch.float32
    _, again = clip.load_clip("ViT-B/32", dtype=torch.bfloat16, device="cpu", seed=1)
    assert torch.equal(again["visual"]["proj"], params["visual"]["proj"])  # seeded

    monkeypatch.setenv("PROTOCLIP_STRICT_WEIGHTS", "1")
    with pytest.raises(FileNotFoundError):
        clip.load_clip("ViT-B/32", device="cpu")
    monkeypatch.delenv("PROTOCLIP_STRICT_WEIGHTS")
    with pytest.raises(ValueError, match="unknown backbone"):
        clip.load_clip("ViT-H/99", device="cpu")


def test_load_clip_needs_the_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        clip.load_clip("ViT-B/32")


@pytest.mark.parametrize("kind", ["fc", "conv-2x", "conv-3x"])
def test_adapters_match_jax(rng, kind):
    d = 20
    jp = np_tree(jadapters.init_adapter(jax.random.PRNGKey(1), d, kind))
    # non-trivial LN affine on both sides
    for key in [k for k in jp if k.startswith("ln")]:
        jp[key]["scale"] = (1 + 0.1 * rng.standard_normal(jp[key]["scale"].shape)).astype(np.float32)
        jp[key]["bias"] = (0.1 * rng.standard_normal(jp[key]["bias"].shape)).astype(np.float32)
    port_p = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = rng.standard_normal((5, d)).astype(np.float32)
    ours = adapters.apply_adapter(port_p, torch.from_numpy(x), kind).numpy()
    ref = np.asarray(jadapters.apply_adapter(jax.tree_util.tree_map(jnp.asarray, jp),
                                             jnp.asarray(x), kind))
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    with pytest.raises(ValueError):
        adapters.apply_adapter(port_p, torch.from_numpy(x), "mlp")
