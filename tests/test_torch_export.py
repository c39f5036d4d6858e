"""The port's serving bundle (``protoclip_tpu_torch/io/export.py``) and export
CLI against the JAX package's, on the CPU, where each bucket is the eager
``make_encode_fn``.

Bars: a JAX-written fp32 bundle served by the port within 1e-5 of JAX's
``load_serving_bundle``; a bf16 one at K2's plain-version bars
(max|diff| / max|JAX| < 1e-2, cosine > 0.9999: JAX on the CPU runs its
MLP in bf16 where the port's plain K2 keeps the fc bias and QuickGELU in
fp32); the port's own save-and-load round trip and its int8 bundle exact
against ``make_encode_fn`` on the same parameters.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protoclip_tpu.io.export import _flatten as jax_flatten
from protoclip_tpu.io.export import _seq_nodes as jax_seq_nodes
from protoclip_tpu.io.export import load_serving_bundle as jax_load
from protoclip_tpu.io.export import save_serving_bundle as jax_save
from protoclip_tpu.models.clip import cast_params as jax_cast_params
from protoclip_tpu.models.clip import init_clip_params as jax_init_clip_params

from protoclip_tpu_torch.io import export
from protoclip_tpu_torch.io.export import load_serving_bundle, make_encode_fn, save_serving_bundle
from protoclip_tpu_torch.models import clip
from protoclip_tpu_torch.ops import kernels
from tests.test_models import TINY_VIT, _tiny_torch_style_state_dict
from tests.test_torch_models import port_config

BF16_BARS = (1e-2, 0.9999)  # max|diff| / max|ref|, flattened cosine
CFG = port_config(TINY_VIT)


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3), np.uint8)


def _bars(ours, ref, bars):
    ours, ref = np.asarray(ours, np.float64).ravel(), np.asarray(ref, np.float64).ravel()
    rel = np.abs(ours - ref).max() / np.abs(ref).max()
    cos = ours @ ref / (np.linalg.norm(ours) * np.linalg.norm(ref))
    assert rel < bars[0] and cos > bars[1], (rel, cos)


@pytest.fixture(scope="module")
def jax_bundles(tmp_path_factory):
    """JAX-written bundles of the tiny ViT, fp32 and bf16, buckets 1/2/4."""
    params = jax_init_clip_params(jax.random.PRNGKey(0), TINY_VIT)
    out = {}
    for name, tree in (("fp32", params),
                       ("bf16", jax.jit(lambda p: jax_cast_params(p, jnp.bfloat16))(params))):
        path = str(tmp_path_factory.mktemp("jax") / name)
        jax_save(path, TINY_VIT, tree, batch_size=4, batch_sizes=(1, 2))
        out[name] = path
    return out


@pytest.fixture(scope="module")
def port_params():
    params = clip.init_clip_params(np.random.default_rng(0), CFG)
    return {"fp32": params, "bf16": clip.cast_params(params, torch.bfloat16)}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_port_serves_a_jax_bundle_as_jax(jax_bundles, dtype):
    ours = load_serving_bundle(jax_bundles[dtype], device="cpu")
    theirs = jax_load(jax_bundles[dtype])
    assert ours.manifest == theirs.manifest
    assert ours.cfg == CFG
    assert sorted(ours.artifacts) == [1, 2, 4]
    images = _images(4)
    for n in (1, 2, 3, 4):
        got, want = ours(images[:n]), theirs(images[:n])
        assert got.shape == (n, 32) and got.dtype == np.float32
        if dtype == "fp32":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        else:
            _bars(got, want, BF16_BARS)
    leaves = [t for _, t in export._leaves(ours.params["visual"])]
    assert {t.dtype for t in leaves} == ({torch.float32} if dtype == "fp32"
                                         else {torch.bfloat16, torch.float32})


def test_port_reads_the_jax_v1_storage(jax_bundles, tmp_path):
    """The JAX package's v1 bundles widened bf16 leaves to fp32: the port
    reads them back to the same bf16 parameters and features."""
    path = str(tmp_path / "v1")
    os.makedirs(path)
    with open(os.path.join(jax_bundles["bf16"], "manifest.json")) as fh:
        manifest = json.load(fh)
    with np.load(os.path.join(jax_bundles["bf16"], "params.npz")) as npz:
        flat = {k: (npz[k].astype(np.uint32) << 16).view(np.float32)
                if k in manifest["param_dtypes"] else npz[k] for k in npz.files}
    np.savez(os.path.join(path, "params.npz"), **flat)
    manifest["format"] = "protoclip_tpu.serving_bundle.v1"
    manifest.pop("param_storage")
    with open(os.path.join(path, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
    images = _images(3, seed=1)
    np.testing.assert_array_equal(load_serving_bundle(path, device="cpu")(images),
                                  load_serving_bundle(jax_bundles["bf16"], device="cpu")(images))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_port_bundle_round_trip_is_exact(port_params, tmp_path, dtype):
    params = port_params[dtype]
    path = str(tmp_path / "bundle")
    save_serving_bundle(path, CFG, params, batch_size=4)
    assert sorted(os.listdir(path)) == ["manifest.json", "params.npz"]
    encode = load_serving_bundle(path, device="cpu")
    for (key, got), (_, want) in zip(export._leaves(encode.params), export._leaves(params)):
        assert got.dtype == want.dtype and torch.equal(got, want), key
    images = _images(4, seed=2)
    np.testing.assert_array_equal(encode(images),
                                  make_encode_fn(CFG)(params, torch.from_numpy(images)).numpy())
    np.testing.assert_allclose(np.linalg.norm(encode(images), axis=-1), 1.0, atol=1e-5)


def test_buckets_route_and_keep_rows(port_params, tmp_path):
    path = str(tmp_path / "bundle")
    save_serving_bundle(path, CFG, port_params["fp32"], batch_size=8, batch_sizes=(2, 4))
    encode = load_serving_bundle(path, device="cpu")
    assert encode.manifest["batch_sizes"] == [2, 4, 8]
    assert sorted(encode.artifacts) == [2, 4, 8]
    assert all(art.graph is None for art in encode.artifacts.values())
    called = []
    for size, art in list(encode.artifacts.items()):
        def spy(rows, art=art, size=size):
            called.append((size, len(rows)))
            return art(rows)
        encode.artifacts[size] = spy
    images = _images(8, seed=3)
    full = encode(images)
    for n in (1, 2, 3, 4, 5, 8):  # exact fit, padded within a bucket, the next bucket
        np.testing.assert_array_equal(encode(images[:n]), full[:n])
    assert called == [(8, 8), (2, 1), (2, 2), (4, 3), (4, 4), (8, 5), (8, 8)]


def test_rejections_and_messages(port_params, tmp_path):
    path = str(tmp_path / "bundle")
    save_serving_bundle(path, CFG, port_params["fp32"], batch_size=4, normalize=False)
    encode = load_serving_bundle(path, device="cpu")
    assert encode.manifest["normalized"] is False
    for bad in (np.zeros((5, 32, 32, 3), np.uint8), np.zeros((0, 32, 32, 3), np.uint8),
                np.zeros((4, 64, 64, 3), np.uint8), np.uint8(7)):
        with pytest.raises(ValueError, match=r"bundle compiled for \(1\.\.4, 32, 32, 3\)"):
            encode(bad)
    with pytest.raises(ValueError, match="uint8"):
        encode(np.zeros((4, 32, 32, 3), np.float32))
    with pytest.raises(ValueError, match="maximum bucket"):
        save_serving_bundle(str(tmp_path / "b"), CFG, port_params["fp32"], batch_size=4,
                            batch_sizes=(8,))
    with pytest.raises(ValueError, match=">= 1"):
        save_serving_bundle(str(tmp_path / "c"), CFG, port_params["fp32"], batch_size=4,
                            batch_sizes=(0,))
    # neither package reads the other's tag wrongly: JAX rejects the port's
    with pytest.raises(ValueError, match="not a protoclip_tpu serving bundle"):
        jax_load(path)
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    manifest["format"] = "something-else"
    with open(os.path.join(path, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
    with pytest.raises(ValueError, match="not a protoclip_tpu serving bundle"):
        load_serving_bundle(path, device="cpu")


def test_manifest_keys_are_jaxs_with_torch_in_place_of_jax(jax_bundles, port_params, tmp_path):
    path = str(tmp_path / "bundle")
    save_serving_bundle(path, CFG, port_params["bf16"], batch_size=4, batch_sizes=(1, 2))
    with open(os.path.join(path, "manifest.json")) as fh:
        ours = json.load(fh)
    with open(os.path.join(jax_bundles["bf16"], "manifest.json")) as fh:
        theirs = json.load(fh)
    assert set(ours) == (set(theirs) - {"platforms", "jax_version"}
                         | {"torch_version", "device_capability"})
    assert ours["format"] == "protoclip_tpu_torch.serving_bundle.v1"
    assert ours["torch_version"] == torch.__version__ and ours["device_capability"] is None
    for key in ("param_storage", "backbone", "backbone_embed_dim", "image_resolution",
                "batch_size", "batch_sizes", "int8", "normalized"):
        assert ours[key] == theirs[key], key
    assert set(ours["param_dtypes"].values()) == {"bfloat16"}
    with np.load(os.path.join(path, "params.npz")) as npz:
        assert all(npz[k].dtype.kind != "V" for k in npz.files)
        assert {npz[k].dtype for k in ours["param_dtypes"]} == {np.dtype(np.uint16)}


def test_flatten_round_trips_the_tree_structure(port_params, tmp_path):
    """The JAX test's tree (lists, a tuple, a digit-keyed dict) flattens to
    JAX's keys and sequence map and comes back with its structure; the
    port's bf16 parameter tree survives npz and JSON bit for bit."""
    tree = {
        "w": np.ones((2, 2), np.float32),
        "blocks": [{"k": np.zeros(3, np.float32)}, {"k": np.ones(3, np.float32)}],
        "pair": (np.float32(1.0), np.float32(2.0)),
        "digit_keyed": {"0": np.zeros(1), "1": np.ones(1)},
    }
    flat, dtypes = export._flatten(tree)
    jflat, jdtypes = jax_flatten(tree)
    assert set(flat) == set(jflat) and dtypes == jdtypes == {}
    assert export._seq_nodes(tree) == jax_seq_nodes(tree)
    np.savez(tmp_path / "p.npz", **flat)
    seq = json.loads(json.dumps(export._seq_nodes(tree)))
    with np.load(tmp_path / "p.npz") as npz:
        rebuilt = export._unflatten({k: npz[k] for k in npz.files}, seq)
    assert jax.tree_util.tree_structure(rebuilt) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(rebuilt), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)

    params = port_params["bf16"]
    flat, dtypes = export._flatten(params)
    np.savez(tmp_path / "q.npz", **flat)
    with np.load(tmp_path / "q.npz") as npz:
        back = export._unflatten({k: export._restore(npz[k], dtypes.get(k)) for k in npz.files},
                                 json.loads(json.dumps(export._seq_nodes(params))))
    assert isinstance(back["visual"]["blocks"], list) and len(back["visual"]["blocks"]) == 2
    for (key, got), (wkey, want) in zip(export._leaves(back), export._leaves(params)):
        assert key == wkey and got.dtype == want.dtype and torch.equal(got, want), key


def test_int8_bundle_serves_k3_whatever_the_environment(port_params, tmp_path, monkeypatch):
    params = port_params["bf16"]
    path8, path = str(tmp_path / "int8"), str(tmp_path / "bf16")
    save_serving_bundle(path8, CFG, clip.quantize_for_serving(params), batch_size=4,
                        batch_sizes=(2,), int8=True)
    save_serving_bundle(path, CFG, params, batch_size=4, batch_sizes=(2,))
    with np.load(os.path.join(path8, "params.npz")) as npz:
        assert not any("blocks_q" in k for k in npz.files)  # quantized at load
    images = torch.from_numpy(_images(4, seed=4))
    monkeypatch.setenv("PROTOCLIP_INT8", "1")
    want8 = make_encode_fn(CFG)(clip.quantize_for_serving(params), images).numpy()
    monkeypatch.setenv("PROTOCLIP_INT8", "0")
    want = make_encode_fn(CFG)(params, images).numpy()
    assert not np.array_equal(want8, want)
    calls = []
    real = kernels.fused_transformer_block_int8
    monkeypatch.setattr("protoclip_tpu_torch.models.layers.fused_transformer_block_int8",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for env in ("0", "1"):
        monkeypatch.setenv("PROTOCLIP_INT8", env)
        enc8, enc = load_serving_bundle(path8, device="cpu"), load_serving_bundle(path, device="cpu")
        assert enc8.manifest["int8"] is True and "blocks_q" in enc8.params["visual"]
        calls.clear()
        np.testing.assert_array_equal(enc8(images.numpy()), want8)
        assert len(calls) == CFG.vision_layers
        np.testing.assert_array_equal(enc8(images.numpy()[:1]), want8[:1])
        calls.clear()
        np.testing.assert_array_equal(enc(images.numpy()), want)
        assert not calls


def test_weight_swap_takes_effect(port_params, tmp_path):
    path = str(tmp_path / "bundle")
    save_serving_bundle(path, CFG, port_params["fp32"], batch_size=2)
    images = _images(2, seed=5)
    before = load_serving_bundle(path, device="cpu")(images)
    with np.load(os.path.join(path, "params.npz")) as npz:
        flat = {k: npz[k].copy() for k in npz.files}
    key = "visual/blocks/0/attn/wo"
    flat[key] = flat[key] + 0.05 * np.random.default_rng(0).standard_normal(
        flat[key].shape).astype(flat[key].dtype)
    np.savez(os.path.join(path, "params.npz"), **flat)
    assert not np.allclose(load_serving_bundle(path, device="cpu")(images), before)


@pytest.fixture(scope="module")
def tiny_weights(tmp_path_factory):
    """The tiny ViT's torch-layout state dict, as a torch .pt and as the
    pickle of numpy arrays that the JAX CLI test writes."""
    sd = _tiny_torch_style_state_dict(np.random.default_rng(0))
    root = tmp_path_factory.mktemp("weights")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, root / "tiny.pt")
    with open(root / "tiny.pkl", "wb") as fh:
        pickle.dump({k: np.asarray(v) for k, v in sd.items()}, fh)
    return str(root / "tiny.pt"), str(root / "tiny.pkl")


def test_export_cli_writes_a_bundle_like_the_jax_cli(tiny_weights, tmp_path):
    from protoclip_tpu.cli.export import main as jax_main

    from protoclip_tpu_torch.cli.export import main

    out, jout = str(tmp_path / "bundle"), str(tmp_path / "jax_bundle")
    main(["--backbone", "tiny", "--weights", tiny_weights[0], "--out", out,
          "--batch", "4", "--buckets", "2", "--device", "cpu"])
    jax_main(["--backbone", "tiny", "--weights", tiny_weights[1], "--out", jout,
              "--batch", "4", "--buckets", "2"])
    encode = load_serving_bundle(out, device="cpu")
    jencode = jax_load(jout)
    assert encode.manifest["batch_sizes"] == jencode.manifest["batch_sizes"] == [2, 4]
    assert encode.manifest["backbone"] == jencode.manifest["backbone"]
    n_px = encode.manifest["image_resolution"]
    images = _images(3, seed=6)[:, :n_px, :n_px]
    got = encode(images)
    assert got.shape[0] == 3 and np.isfinite(got).all()
    _bars(got, jencode(images), BF16_BARS)  # both CLIs export bf16 weights
    # the port's CLI reads the JAX bundle the JAX CLI wrote, to the same rows
    _bars(load_serving_bundle(jout, device="cpu")(images), got, BF16_BARS)


def test_export_cli_defaults_to_the_card(tiny_weights, tmp_path):
    from protoclip_tpu_torch.cli.export import build_parser, main

    assert build_parser().parse_args(["--out", "x"]).device == "cuda"
    assert not any(a.dest == "platform" for a in build_parser()._actions)
    if torch.cuda.is_available():
        pytest.skip("the card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--backbone", "tiny", "--weights", tiny_weights[0], "--out",
              str(tmp_path / "b"), "--batch", "2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_serving_bundle(str(tmp_path / "b"))
