"""The bank build's ragged last batch on the CPU: ``encode_loader`` hands the
image encode only a batch's valid rows, from ``ArrayLoader`` (which yields
the ragged batch as a view) and from ``BatchLoader`` (which fills a zeroed
``batch_size`` buffer); a mesh encode pads a batch that does not divide
over the mesh and returns the batch's own rows; ``pad_last=True`` still
pads.  The encode is ``train.runner.make_encode_fns`` on the port's tiny
ViT (32 px, fp32)."""

import numpy as np
import pytest
import torch
from PIL import Image

from protoclip_tpu_torch.core.config import Config
from protoclip_tpu_torch.data.loader import ArrayLoader, BatchLoader
from protoclip_tpu_torch.data.types import Datum
from protoclip_tpu_torch.memory.banks import encode_loader
from protoclip_tpu_torch.obs import profiler
from protoclip_tpu_torch.parallel import make_mesh
from protoclip_tpu_torch.parallel.dryrun import tiny_state_dict
from protoclip_tpu_torch.train.runner import make_encode_fns

PX = 32  # the tiny ViT's resolution


@pytest.fixture(scope="module")
def tiny_cfg(tmp_path_factory):
    path = tmp_path_factory.mktemp("ragged") / "tiny.pt"
    torch.save(tiny_state_dict(np.random.default_rng(0)), path)
    return Config(backbone="ViT-B/16", weights_path=str(path), compute_dtype="float32")


def _recording(encode):
    rows = []

    def encode_fn(images_u8):
        rows.append(len(images_u8))
        return encode(images_u8)

    return encode_fn, rows


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, PX, PX, 3), dtype=np.uint8)


def test_array_loader_hands_the_encode_valid_rows_only(tiny_cfg):
    images = _images(3168)
    labels = np.arange(3168, dtype=np.int32) % 198
    encode = make_encode_fns(tiny_cfg, device="cpu")[0]
    profiler.clear()
    encode_fn, rows = _recording(encode)
    feats, got = encode_loader(encode_fn, ArrayLoader(images, labels, batch_size=1024))
    assert rows == [1024, 1024, 1024, 96]
    assert ("loader.pad", "") not in profiler.totals()
    padded_fn, padded_rows = _recording(encode)
    want, want_labels = encode_loader(padded_fn,
                                      ArrayLoader(images, labels, batch_size=1024, pad_last=True))
    assert padded_rows == [1024, 1024, 1024, 96]  # the loader pads; the encode never sees it
    np.testing.assert_array_equal(feats, want)
    np.testing.assert_array_equal(got, labels)
    np.testing.assert_array_equal(want_labels, labels)
    # the short batch's rows against the first rows of the padded 1024-row call
    tail = np.concatenate([images[3072:], np.zeros((928, PX, PX, 3), np.uint8)])
    np.testing.assert_allclose(feats[3072:], encode(tail).numpy()[:96], rtol=0, atol=1e-6)


def test_batch_loader_ragged_batch_encodes_its_valid_rows(tiny_cfg, tmp_path):
    rng = np.random.default_rng(1)
    items = []
    for i in range(6):
        path = str(tmp_path / f"{i}.png")
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(path)
        items.append(Datum(path, i % 3, f"c{i % 3}"))
    loader = BatchLoader(items, batch_size=4, num_threads=2, image_size=PX)
    encode = make_encode_fns(tiny_cfg, device="cpu")[0]
    encode_fn, rows = _recording(encode)
    feats, labels = encode_loader(encode_fn, loader)
    assert rows == [4, 2]
    assert feats.shape == (6, 32) and list(labels) == [i % 3 for i in range(6)]
    batches = list(loader)  # the same bytes: the eval transform draws nothing
    assert batches[-1][0].shape[0] == 4 and batches[-1][2] == 2
    want = np.concatenate([encode(b[0]).numpy()[:b[2]] for b in batches])
    np.testing.assert_allclose(feats, want, rtol=0, atol=1e-6)


def test_mesh_encode_pads_a_batch_that_does_not_divide(tiny_cfg):
    """6 rows over a mesh of 4: padded to 8 inside the encode (the upload
    span counts 8 rows), 6 rows back, each the unsharded encode's row."""
    mesh = make_mesh(4, devices=["cpu"] * 4)
    sharded = make_encode_fns(tiny_cfg, mesh=mesh)[0]
    single = make_encode_fns(tiny_cfg, device="cpu")[0]
    images = _images(6, seed=2)
    profiler.clear()
    got = sharded(images)
    assert profiler.totals()[("encode.upload", "")][2] == 8
    assert tuple(got.shape) == (6, 32)
    np.testing.assert_allclose(got.numpy(), single(images).numpy(), rtol=0, atol=1e-5)
    assert not np.allclose(got[0].numpy(), got[5].numpy())
    got = sharded(images[:4])  # a batch that divides is not padded
    np.testing.assert_allclose(got.numpy(), single(images[:4]).numpy(), rtol=0, atol=1e-5)


def test_array_loader_pad_last_still_pads():
    images = np.arange(10 * 2 * 2 * 3, dtype=np.uint8).reshape(10, 2, 2, 3)
    labels = np.arange(1, 11, dtype=np.int32)
    profiler.clear()
    padded = list(ArrayLoader(images, labels, batch_size=4, pad_last=True))
    assert [(len(b[0]), len(b[1]), b[2]) for b in padded] == [(4, 4, 4), (4, 4, 4), (4, 4, 2)]
    np.testing.assert_array_equal(padded[-1][0][:2], images[8:])
    assert not padded[-1][0][2:].any() and not padded[-1][1][2:].any()
    assert profiler.totals()[("loader.pad", "")][2] == 2
    ragged = list(ArrayLoader(images, labels, batch_size=4))
    assert [(len(b[0]), b[2]) for b in ragged] == [(4, 4), (4, 4), (2, 2)]
    assert ragged[-1][0].base is not None  # a view of the arrays, not a copy
