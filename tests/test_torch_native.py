"""The port's native preprocess (``protoclip_tpu_torch/native``) on the CPU:
the fused bicubic resize + center crop (the entry point the port's
transforms call), the plain bicubic resize and the box resize with its
fused flip, each pixel-exact with PIL and with the JAX package's
``native`` over the geometries of ``tests/test_native.py``; the port's
batch entry, byte for byte the single one over ragged crops at one worker
and at one a core, with per-crop refusals; the
``$PROTOCLIP_NATIVE`` gate; the build directory and key of its own; the
eviction of a stale object."""

import numpy as np
import pytest
from PIL import Image

from protoclip_tpu import native as jax_native
from protoclip_tpu.data.transforms import clip_preprocess as jax_clip_preprocess

from protoclip_tpu_torch import native
from protoclip_tpu_torch.data.transforms import (center_crop, clip_preprocess,
                                                 random_train_transform, resize_shorter,
                                                 sample_rrc_box)
from tests.test_native import GEOMETRIES


@pytest.fixture()
def built(monkeypatch):
    """Both packages' libraries, or a skip where g++ cannot build them."""
    monkeypatch.delenv("PROTOCLIP_NATIVE", raising=False)
    try:
        ours, theirs = native.load(), jax_native.load()
    except RuntimeError:
        ours = theirs = None
    if ours is None or theirs is None:
        pytest.skip("native preprocess unavailable (no g++)")
    return ours


def _pil(src, size, crop):
    return np.asarray(center_crop(resize_shorter(Image.fromarray(src), size), crop))


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_fused_resize_crop_pixel_exact(built, h, w):
    src = np.random.default_rng(h * 1000 + w).integers(0, 256, (h, w, 3), np.uint8)
    got = native.resize_shorter_center_crop(src, 224, 224)
    np.testing.assert_array_equal(got, _pil(src, 224, 224))
    np.testing.assert_array_equal(got, jax_native.resize_shorter_center_crop(src, 224, 224))


@pytest.mark.parametrize("size,crop", [(256, 224), (288, 224), (300, 96), (97, 64)])
def test_size_not_equal_crop_pixel_exact(built, size, crop):
    src = np.random.default_rng(size * 31 + crop).integers(0, 256, (375, 500, 3), np.uint8)
    got = native.resize_shorter_center_crop(src, size, crop)
    np.testing.assert_array_equal(got, _pil(src, size, crop))
    np.testing.assert_array_equal(got, jax_native.resize_shorter_center_crop(src, size, crop))


def test_fuzz_geometries(built):
    rng = np.random.default_rng(0)
    for _ in range(25):
        h, w = int(rng.integers(30, 900)), int(rng.integers(30, 900))
        n_px = int(rng.choice([96, 224, 288, 336]))
        src = rng.integers(0, 256, (h, w, 3), np.uint8)
        got = native.resize_shorter_center_crop(src, n_px, n_px)
        assert got is not None, (h, w, n_px)
        np.testing.assert_array_equal(got, _pil(src, n_px, n_px), err_msg=f"{h}x{w} {n_px}")
        np.testing.assert_array_equal(got, jax_native.resize_shorter_center_crop(src, n_px, n_px))


def test_bad_shapes_are_declined(built):
    assert native.resize_shorter_center_crop(np.zeros((10, 10), np.uint8), 224, 224) is None
    out = clip_preprocess(Image.new("L", (300, 260), 128), 224)  # converted before the call
    assert out.shape == (224, 224, 3) and (out == 128).all()


def test_clip_preprocess_is_native_and_equals_pil_and_jax(built, monkeypatch):
    src = np.random.default_rng(5).integers(0, 256, (375, 500, 3), np.uint8)
    img = Image.fromarray(src)
    calls = []
    real = native.resize_shorter_center_crop

    def spy(*args):
        calls.append(args[1:])
        return real(*args)

    monkeypatch.setattr(native, "resize_shorter_center_crop", spy)
    via_native = clip_preprocess(img, 224)
    assert calls == [(224, 224)]  # not a PIL-against-PIL pass
    monkeypatch.setenv("PROTOCLIP_NATIVE", "0")
    via_pil = clip_preprocess(img, 224)
    assert len(calls) == 1
    np.testing.assert_array_equal(via_native, via_pil)
    np.testing.assert_array_equal(via_native, jax_clip_preprocess(img, 224))


def _ragged_crops(rng, n):
    """``n`` crops of a seeded fuzz: the extreme 1x1, 1x300 and 300x1 first,
    then sides 60-200, every third one a non-contiguous view."""
    extremes = [(1, 1), (1, 300), (300, 1)]
    crops = []
    for i in range(n):
        h, w = extremes[i] if i < len(extremes) else (int(v) for v in rng.integers(60, 201, 2))
        if i >= len(extremes) and i % 3 == 0:  # a strided window of a larger frame
            frame = rng.integers(0, 256, (2 * h + 3, w + 7, 3), np.uint8)
            crops.append(frame[1::2][:h, 3:3 + w])
        else:
            crops.append(rng.integers(0, 256, (h, w, 3), np.uint8))
    return crops


@pytest.mark.parametrize("workers", ["one", "affinity"])
@pytest.mark.parametrize("n", [1, 2, 7, 16, 17])
def test_batch_entry_is_byte_identical_to_single_and_pil(built, monkeypatch, n, workers):
    if workers == "one":
        monkeypatch.setattr(native.os, "sched_getaffinity", lambda pid: {0})
    rng = np.random.default_rng(100 + n)
    crops = _ragged_crops(rng, n)
    assert n < 4 or not crops[3].flags.c_contiguous
    out = np.empty((n, 224, 224, 3), np.uint8)
    status = native.resize_shorter_center_crop_batch(crops, 224, 224, out)
    assert status.tolist() == [0] * n
    for i, crop in enumerate(crops):
        msg = f"crop {i}: {crop.shape}"
        np.testing.assert_array_equal(out[i], native.resize_shorter_center_crop(crop, 224, 224),
                                      err_msg=msg)
        np.testing.assert_array_equal(out[i], _pil(np.ascontiguousarray(crop), 224, 224),
                                      err_msg=msg)


def test_batch_entry_reports_declined_crops(built):
    rng = np.random.default_rng(7)
    crops = [rng.integers(0, 256, (h, w, 3), np.uint8) for h, w in ((80, 120), (0, 40),
                                                                   (150, 90), (40, 0))]
    assert native.resize_shorter_center_crop(crops[1], 64, 64) is None  # declined alone too
    out = np.zeros((4, 64, 64, 3), np.uint8)
    status = native.resize_shorter_center_crop_batch(crops, 64, 64, out)
    assert status.tolist() == [0, 1, 0, 1]
    for i in (0, 2):
        np.testing.assert_array_equal(out[i], _pil(crops[i], 64, 64))
    # an upscale whose resized image is smaller than the crop: every crop declined
    status = native.resize_shorter_center_crop_batch(crops[::2], 48, 64, out[:2])
    assert status.tolist() == [2, 2]


def test_batch_entry_validates_and_obeys_the_gate(built, monkeypatch):
    crops = [np.zeros((30, 40, 3), np.uint8)]
    for bad in (np.zeros((2, 32, 32, 3), np.uint8), np.zeros((1, 32, 32, 3), np.float32),
                np.zeros((1, 32, 64, 3), np.uint8)[:, :, ::2]):
        with pytest.raises(ValueError, match="out must be"):
            native.resize_shorter_center_crop_batch(crops, 32, 32, bad)
    with pytest.raises(ValueError, match="crops must be"):
        native.resize_shorter_center_crop_batch([np.zeros((30, 40), np.uint8)], 32, 32,
                                                np.zeros((1, 32, 32, 3), np.uint8))
    assert native.resize_shorter_center_crop_batch([], 32, 32,
                                                   np.zeros((0, 32, 32, 3), np.uint8)).size == 0
    monkeypatch.setenv("PROTOCLIP_NATIVE", "0")
    assert native.resize_shorter_center_crop_batch(crops, 32, 32,
                                                   np.zeros((1, 32, 32, 3), np.uint8)) is None


def test_batch_entry_more_workers_than_crops_and_cores(built):
    """Many more threads than cores, each crop taken once: the atomic index
    hands out every crop exactly once, whatever the interleaving."""
    import ctypes
    import os

    rng = np.random.default_rng(11)
    crops = [rng.integers(0, 256, (int(h), int(w), 3), np.uint8)
             for h, w in rng.integers(8, 48, (96, 2))]
    n, workers = len(crops), 4 * len(os.sched_getaffinity(0)) + 1
    out = np.zeros((n, 16, 16, 3), np.uint8)
    ptrs = (ctypes.c_void_p * n)(*(c.ctypes.data for c in crops))
    in_h = np.array([c.shape[0] for c in crops], np.intc)
    in_w = np.array([c.shape[1] for c in crops], np.intc)
    for _ in range(5):
        status = np.full(n, -1, np.intc)
        out[:] = 0
        assert built.resize_shorter_center_crop_batch(
            ptrs, in_h.ctypes.data, in_w.ctypes.data, n, out.ctypes.data, 16, 16, workers,
            status.ctypes.data) == 0
        assert status.tolist() == [0] * n
        for i, crop in enumerate(crops):
            np.testing.assert_array_equal(out[i], native.resize_shorter_center_crop(crop, 16, 16))


@pytest.mark.parametrize("oh,ow", [(224, 298), (298, 224), (224, 224), (112, 149), (448, 640)])
def test_resize_bicubic_pixel_exact(built, oh, ow):
    src = np.random.default_rng(oh * 7 + ow).integers(0, 256, (375, 500, 3), np.uint8)
    got = native.resize_bicubic(src, oh, ow)
    np.testing.assert_array_equal(got, np.asarray(Image.fromarray(src).resize((ow, oh),
                                                                              Image.BICUBIC)))
    np.testing.assert_array_equal(got, jax_native.resize_bicubic(src, oh, ow))


@pytest.mark.parametrize("flip", [False, True])
def test_fuzz_resize_box_vs_pil_and_jax(built, flip):
    rng = np.random.default_rng(1 + flip)
    for _ in range(20):
        h, w = int(rng.integers(20, 600)), int(rng.integers(20, 600))
        src = rng.integers(0, 256, (h, w, 3), np.uint8)
        cw, ch = int(rng.integers(4, w + 1)), int(rng.integers(4, h + 1))
        left, top = int(rng.integers(0, w - cw + 1)), int(rng.integers(0, h - ch + 1))
        size = int(rng.integers(16, 300))
        box = (left, top, left + cw, top + ch)
        ref = Image.fromarray(src).resize((size, size), Image.BICUBIC, box=box)
        if flip:
            ref = ref.transpose(Image.FLIP_LEFT_RIGHT)
        got = native.resize_box(src, size, size, box, flip)
        msg = f"{h}x{w} box={box} size={size}"
        np.testing.assert_array_equal(got, np.asarray(ref), err_msg=msg)
        np.testing.assert_array_equal(got, jax_native.resize_box(src, size, size, box, flip),
                                      err_msg=msg)


@pytest.mark.parametrize("box", [(10, 10, 10, 20), (-1, 0, 32, 32), (0, 0, 65, 32)],
                         ids=["zero_width", "left_out_of_bounds", "right_out_of_bounds"])
def test_resize_box_declines_degenerate_boxes(built, box):
    src = np.zeros((64, 64, 3), np.uint8)
    assert native.resize_box(src, 32, 32, box) is None
    assert jax_native.resize_box(src, 32, 32, box) is None


def test_resize_box_matches_the_train_transform(built):
    """Fed the box and flip the port's ``random_train_transform`` draws,
    ``resize_box`` gives its bytes."""
    import random

    src = np.random.default_rng(7).integers(0, 256, (375, 500, 3), np.uint8)
    img = Image.fromarray(src)
    for seed in range(6):
        ref = random_train_transform(img, random.Random(seed), 224)
        rng = random.Random(seed)  # replay the same draws
        box = sample_rrc_box(500, 375, rng)
        flip = rng.random() < 0.5
        np.testing.assert_array_equal(native.resize_box(src, 224, 224, box, flip), ref)


def test_env_gate(built, monkeypatch):
    monkeypatch.setenv("PROTOCLIP_NATIVE", "0")
    assert native.load() is None
    assert native.resize_shorter_center_crop(np.zeros((64, 64, 3), np.uint8), 224, 224) is None
    assert native.resize_bicubic(np.zeros((64, 64, 3), np.uint8), 32, 32) is None
    assert native.resize_box(np.zeros((64, 64, 3), np.uint8), 32, 32, (0, 0, 32, 32)) is None
    # forced on with no toolchain: every call raises, none falls back to PIL
    monkeypatch.setenv("PROTOCLIP_NATIVE", "1")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_build", lambda: None)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="PROTOCLIP_NATIVE=1"):
            clip_preprocess(Image.new("RGB", (40, 30)), 32)


def test_build_is_the_ports_own_and_a_stale_object_is_rebuilt(built, monkeypatch, tmp_path):
    path = native._build()
    assert str(native.BUILD_DIR) in path and path != jax_native._build()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    fresh = native._build()
    assert fresh.startswith(str(tmp_path))
    with open(fresh, "wb") as fh:
        fh.write(b"not an elf object")  # a stale entry
    assert native.load() is not None, "the loader must rebuild past the stale object"
    src = np.random.default_rng(3).integers(0, 256, (64, 80, 3), np.uint8)
    np.testing.assert_array_equal(native.resize_shorter_center_crop(src, 32, 32),
                                  _pil(src, 32, 32))
