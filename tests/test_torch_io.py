"""The port's checkpoint triples, feature cache and adapter state dicts
against the JAX package's, on the CPU: files written by either package are
read by the other, bit for bit."""

import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.serialization

import jax
import jax.numpy as jnp

from protoclip_tpu.eval import gridsearch as jgrid
from protoclip_tpu.io import checkpoint as jckpt
from protoclip_tpu.memory.cache import FeatureCache as JaxFeatureCache
from protoclip_tpu.models import adapters as jadapters

from protoclip_tpu_torch.eval import gridsearch
from protoclip_tpu_torch.io import checkpoint as ckpt
from protoclip_tpu_torch.memory.cache import FeatureCache
from protoclip_tpu_torch.models import adapters
from protoclip_tpu_torch.train.runner import _cached_grid

ADAPTER_KINDS = ["fc", "conv-2x", "conv-3x"]


def triple_args(rng, d=12, n=3, k=2):
    bank_v = rng.standard_normal((n * k, d)).astype(np.float32)
    bank_t = rng.standard_normal((n, d)).astype(np.float32)
    state = jadapters.adapter_to_torch_state(
        jadapters.init_adapter(jax.random.PRNGKey(0), d, "fc"), "fc")
    return bank_v, bank_t, state


def assert_triples_equal(a, b):
    for x, y in zip(a[:2], b[:2]):
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x, y)
    assert a[2].keys() == b[2].keys()
    for key in a[2]:
        np.testing.assert_array_equal(a[2][key], b[2][key])


def test_checkpoint_paths_match_jax():
    args = ("caches/fewsol", "ViT-B/16", 16, 0.5, 1.0, 1e-4, 10, 2000)
    assert ckpt.checkpoint_paths(*args) == jckpt.checkpoint_paths(*args)
    assert ckpt.checkpoint_paths(*args, qt=True) == jckpt.checkpoint_paths(*args, qt=True)
    assert ckpt.beautify("ViT-L/14") == jckpt.beautify("ViT-L/14") == "ViT_L_14"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_triples_cross_read_bit_exact_in_fp16(tmp_path, rng, writer):
    bank_v, bank_t, state = triple_args(rng)
    paths = ckpt.checkpoint_paths(str(tmp_path), "RN50", 2, 0.5, 1.0, 1e-3, 2, 3)
    save = jckpt.save_checkpoint_triple if writer == "jax" else ckpt.save_checkpoint_triple
    save(*paths, bank_v, bank_t, state)
    ours = ckpt.load_checkpoint_triple(*paths)
    theirs = jckpt.load_checkpoint_triple(*paths)
    assert_triples_equal(ours, theirs)
    # stored as the reference stores them: fp16 tensors and a state dict
    raw = torch.load(paths[0], weights_only=True)
    assert raw.dtype == torch.float16
    np.testing.assert_array_equal(ours[0], bank_v.astype(np.float16).astype(np.float32))
    assert set(torch.load(paths[2], weights_only=True)) == set(state)
    assert not any(name.endswith(".tmp") for name in os.listdir(os.path.dirname(paths[0])))


def test_triple_npz_sidecars_of_a_torchless_jax_host(tmp_path, rng):
    """A JAX host without torch writes ``<path>.npz`` sidecars; the port reads
    them, and its own save replaces them with the ``.pt`` files."""
    bank_v, bank_t, state = triple_args(rng)
    paths = ckpt.checkpoint_paths(str(tmp_path), "RN50", 2, 0.5, 1.0, 1e-3, 2, 3)
    os.makedirs(os.path.dirname(paths[0]))
    f16 = {k: v.astype(np.float16) for k, v in state.items()}
    for path, arrays in zip(paths, ({"weight": bank_v.astype(np.float16)},
                                    {"weight": bank_t.astype(np.float16)}, f16)):
        jckpt._savez_exact(path + ".npz", arrays)
    ours = ckpt.load_checkpoint_triple(*paths)
    assert_triples_equal(ours, jckpt.load_checkpoint_triple(*paths))
    ckpt.save_checkpoint_triple(*paths, bank_v, bank_t, state)
    assert all(os.path.exists(p) and not os.path.exists(p + ".npz") for p in paths)
    assert_triples_equal(ckpt.load_checkpoint_triple(*paths), ours)


@pytest.mark.parametrize("kind", ADAPTER_KINDS)
def test_adapter_state_dicts_round_trip_through_jax(rng, kind):
    d = 20
    x = rng.standard_normal((4, d)).astype(np.float32)
    ours = adapters.init_adapter(torch.Generator().manual_seed(0), d, kind)
    theirs = jadapters.init_adapter(jax.random.PRNGKey(0), d, kind)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), theirs)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), ours) == shapes
    again = adapters.init_adapter(torch.Generator().manual_seed(0), d, kind)
    assert all(torch.equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(ours),
                                                 jax.tree_util.tree_leaves(again)))

    # port -> torch state -> JAX, and JAX -> torch state -> port
    state = adapters.adapter_to_torch_state(ours, kind)
    assert state.keys() == jadapters.adapter_to_torch_state(theirs, kind).keys()
    jp = jadapters.adapter_from_torch_state(state, kind)
    np.testing.assert_allclose(
        adapters.apply_adapter(ours, torch.from_numpy(x), kind).numpy(),
        np.asarray(jadapters.apply_adapter(jp, jnp.asarray(x), kind)), atol=1e-5)
    jstate = jadapters.adapter_to_torch_state(theirs, kind)
    back = adapters.adapter_from_torch_state(jstate, kind)
    np.testing.assert_allclose(
        adapters.apply_adapter(back, torch.from_numpy(x), kind).numpy(),
        np.asarray(jadapters.apply_adapter(theirs, jnp.asarray(x), kind)), atol=1e-5)
    again_state = adapters.adapter_to_torch_state(back, kind)
    assert again_state.keys() == jstate.keys()
    for key, value in again_state.items():
        assert value.dtype == np.float32
        np.testing.assert_array_equal(value, jstate[key])


def test_feature_cache_paths_and_npz_both_ways(tmp_path, rng):
    ours = FeatureCache(str(tmp_path), "ViT-B/16", 4)
    theirs = JaxFeatureCache(str(tmp_path), "ViT-B/16", 4)
    assert ours.root == theirs.root
    assert ours.visual_bank_stems(10) == theirs.visual_bank_stems(10)
    assert ours.text_bank_stem() == theirs.text_bank_stem() == "text_mb_ViT_B_16_K_4"
    assert ours.split_stems("val") == theirs.split_stems("val")
    assert ours.hp_search_stem("test") == theirs.hp_search_stem("test")
    keys = rng.standard_normal((8, 6)).astype(np.float32)
    ours.save(ours.visual_bank_stems(2)[0], keys=keys)
    np.testing.assert_array_equal(theirs.load(theirs.visual_bank_stems(2)[0])["keys"], keys)
    theirs.save("test_labels", labels=np.arange(5))
    np.testing.assert_array_equal(ours.load("test_labels")["labels"], np.arange(5))
    assert ours.load("val_features") is None


def test_feature_cache_reads_reference_pt_and_cuda_pickles(tmp_path, rng, monkeypatch):
    """The reference's ``.pt`` caches and its raw-pickled textual bank (a
    CUDA tensor: its storage records 'cuda:0') and HP grid load on a host
    without CUDA, as JAX's reader loads them."""
    ours = FeatureCache(str(tmp_path), "RN50", 2)
    theirs = JaxFeatureCache(str(tmp_path), "RN50", 2)
    os.makedirs(ours.root)
    feats = rng.standard_normal((5, 8)).astype(np.float32)
    torch.save(torch.from_numpy(feats), os.path.join(ours.root, "val_features.pt"))
    bank = torch.from_numpy(rng.standard_normal((8, 3)).astype(np.float32)).half()
    alphas, betas = gridsearch.default_alpha_beta_grid()
    acc = rng.random((len(alphas), len(betas))).astype(np.float32)
    with monkeypatch.context() as m:
        m.setattr(torch.serialization, "location_tag", lambda storage: "cuda:0")
        blob = pickle.dumps(bank)
    assert b"cuda:0" in blob
    with open(os.path.join(ours.root, ours.text_bank_stem() + ".pkl"), "wb") as fh:
        fh.write(blob)
    with open(os.path.join(ours.root, ours.hp_search_stem("val") + ".pkl"), "wb") as fh:
        pickle.dump(gridsearch.sweep_to_triples(acc, alphas, betas), fh)

    for stem in ("val_features", ours.text_bank_stem(), ours.hp_search_stem("val")):
        got, want = ours.load(stem), theirs.load(stem)
        assert got.keys() == want.keys() == {"array"}, stem
        assert got["array"].dtype == want["array"].dtype, stem
        np.testing.assert_array_equal(got["array"], want["array"])
    np.testing.assert_array_equal(ours.load(ours.text_bank_stem())["array"], bank.numpy())
    grid = _cached_grid(ours, ours.hp_search_stem("val"), 3, alphas, betas)
    np.testing.assert_array_equal(grid, jgrid.triples_to_sweep(
        theirs.load(ours.hp_search_stem("val"))["array"], alphas, betas))


def test_restricted_unpickler_refuses_callables(tmp_path):
    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    path = tmp_path / "evil.pkl"
    path.write_bytes(pickle.dumps({"bank": Evil()}))
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        ckpt.load_pkl(str(path))


def test_cached_grids_are_checked_before_use(tmp_path, rng):
    """An npz grid of another class count, a grid without its count, and a
    pickled grid that does not cover the default grid or holds accuracies
    outside [0, 1] are recomputed (``None``), as in JAX's
    ``zero_shot_sweep_phase``."""
    cache = FeatureCache(str(tmp_path), "RN50", 2)
    alphas, betas = gridsearch.default_alpha_beta_grid()
    acc = rng.random((len(alphas), len(betas))).astype(np.float32)
    cache.save("ok", acc=acc, n_class=np.int64(3))
    np.testing.assert_array_equal(_cached_grid(cache, "ok", 3, alphas, betas), acc)
    assert _cached_grid(cache, "ok", 4, alphas, betas) is None
    cache.save("no_count", acc=acc)
    assert _cached_grid(cache, "no_count", 3, alphas, betas) is None
    triples = gridsearch.sweep_to_triples(acc, alphas, betas)
    cache.save("short", triples=triples[:-1])
    assert _cached_grid(cache, "short", 3, alphas, betas) is None
    bad = triples.copy()
    bad[0, 2] = 1.5
    cache.save("bad", triples=bad)
    assert _cached_grid(cache, "bad", 3, alphas, betas) is None
    cache.save("good", triples=triples)
    np.testing.assert_array_equal(_cached_grid(cache, "good", 3, alphas, betas), acc)
    assert _cached_grid(cache, "absent", 3, alphas, betas) is None


def test_corrupt_entries_are_rebuilt_and_stale_tmp_swept(tmp_path):
    cache = FeatureCache(str(tmp_path), "RN50", 2)
    os.makedirs(os.path.join(cache.root, "aug"))
    path = os.path.join(cache.root, "val_features.npz")
    with open(path, "wb") as fh:
        fh.write(b"PK\x03\x04 truncated")
    assert cache.load("val_features") is None and not os.path.exists(path)

    old = os.path.join(cache.root, "aug", "x.npz.tmp-1-deadbeef")
    fresh = os.path.join(cache.root, "y.npz.tmp-2-cafef00d")
    for p in (old, fresh):
        with open(p, "wb") as fh:
            fh.write(b"partial")
    stale = time.time() - 7200
    os.utime(old, (stale, stale))
    FeatureCache(str(tmp_path), "RN50", 2)
    assert not os.path.exists(old) and os.path.exists(fresh)
    cache.save("val_features", features=np.ones((2, 2), np.float32))
    assert sorted(os.listdir(cache.root)) == ["aug", "val_features.npz", "y.npz.tmp-2-cafef00d"]


def test_load_pt_maps_bfloat16_to_float32(tmp_path):
    t = torch.randn(3, 4).to(torch.bfloat16)
    path = tmp_path / "bf16.pt"
    torch.save({"weight": t}, path)
    out = ckpt.load_pt(str(path))
    assert out["weight"].dtype == np.float32
    np.testing.assert_array_equal(out["weight"], t.float().numpy())
