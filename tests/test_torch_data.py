"""The port's host data path against the JAX package's, on the CPU: dataset
builders and few-shot picks on small synthetic trees, the MAT reader, the
threaded loader's batches (byte for byte) and the configs."""

import glob
import json
import os
import random
import shutil

import numpy as np
import pytest
from PIL import Image

from protoclip_tpu.core import config as jconfig
from protoclip_tpu.data import loader as jloader
from protoclip_tpu.data import registry as jregistry
from protoclip_tpu.data import transforms as jtransforms
from protoclip_tpu.data.types import Datum as JaxDatum
from protoclip_tpu.io import mat as jmat

from protoclip_tpu_torch.core import config
from protoclip_tpu_torch.data import loader, registry, transforms
from protoclip_tpu_torch.data.types import Datum
from protoclip_tpu_torch.io import mat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ["apple_pie", "banana", "cherry"]


def write_image(path, rng, size=(30, 22)):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)).save(path)


def json_tree(root, rng, dataset_dir, image_subdir, split_file, per_class=5):
    rows = {"train": [], "val": [], "test": []}
    for c, cname in enumerate(CLASSES):
        for i in range(per_class):
            rel = f"{cname}/{i}.jpg"
            write_image(os.path.join(root, dataset_dir, image_subdir, rel), rng)
            rows[["train", "train", "train", "val", "test"][i]].append([rel, c, cname])
    with open(os.path.join(root, dataset_dir, split_file), "w") as fh:
        json.dump(rows, fh)


def fgvc_tree(root, rng):
    d = os.path.join(root, "fgvc_aircraft")
    names = ["707-320", "A300B4", "Cessna 172"]
    with open(os.path.join(_mkdir(d), "variants.txt"), "w") as fh:
        fh.write("\n".join(names) + "\n")
    for split in ("train", "val", "test"):
        with open(os.path.join(d, f"images_variant_{split}.txt"), "w") as fh:
            for c, name in enumerate(names):
                for i in range(3):
                    stem = f"{split}{c}{i:04d}"
                    write_image(os.path.join(d, "images", stem + ".jpg"), rng)
                    fh.write(f"{stem} {name}\n")


def imagenet_tree(root, rng):
    for split in ("train", "val"):
        for wnid in ("n02", "n01", "n03"):
            for i in range(3):
                write_image(os.path.join(root, "imagenet", "images", split, wnid, f"{i}.JPEG"),
                            rng)


def flowers_tree(root, rng):
    """oxford_flowers without its split JSON: the builder reads
    ``imagelabels.mat`` (written by scipy) and ``cat_to_name.json``."""
    import scipy.io

    d = _mkdir(os.path.join(root, "oxford_flowers"))
    labels = np.repeat(np.arange(1, 4), 6)
    for i in range(len(labels)):
        write_image(os.path.join(d, "jpg", f"image_{i + 1:05d}.jpg"), rng)
    scipy.io.savemat(os.path.join(d, "imagelabels.mat"), {"labels": labels[None, :]})
    with open(os.path.join(d, "cat_to_name.json"), "w") as fh:
        json.dump({"1": "pink primrose", "2": "globe thistle", "3": "blanket flower"}, fh)


def _mkdir(path):
    os.makedirs(path, exist_ok=True)
    return path


def records(ds, root):
    """Each split's Datum fields, the tree's root replaced by a marker."""
    return {split: [(d.impath.replace(root, "<root>"), d.label, d.classname, d.domain)
                    for d in getattr(ds, split)]
            for split in ("train_x", "val", "test")}


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    rng = np.random.default_rng(0)
    json_tree(root, rng, "caltech-101", "101_ObjectCategories", "split_zhou_Caltech101.json")
    json_tree(root, rng, "fewsol", "data", "fewsol_splits_198.json")
    fgvc_tree(root, rng)
    imagenet_tree(root, rng)
    flowers_tree(root, rng)
    return root


def test_registry_lists_the_same_datasets():
    assert registry.available_datasets() == jregistry.available_datasets()
    assert len(registry.available_datasets()) == 13
    assert registry.imagenet_classnames_and_templates() == \
        jregistry.imagenet_classnames_and_templates()
    with pytest.raises(KeyError):
        registry.build_dataset("mnist", "/nonexistent", 1)


@pytest.mark.parametrize("alias", ["caltech101", "fgvc", "imagenet", "fewsol_198",
                                   "oxford_flowers"])
@pytest.mark.parametrize("shots,seed", [(2, 1), (4, 7)])
def test_build_dataset_matches_jax(data_root, tmp_path, alias, shots, seed):
    """The same Datum lists and few-shot picks as JAX for the same seed.
    Each package builds in its own copy of the tree, so a split file that a
    builder generates (oxford_flowers, from its ``.mat``) is generated by
    both."""
    roots = {}
    for pkg in ("jax", "port"):
        roots[pkg] = str(tmp_path / pkg)
        shutil.copytree(data_root, roots[pkg])
    ours = registry.build_dataset(alias, roots["port"], shots, seed=seed)
    theirs = jregistry.build_dataset(alias, roots["jax"], shots, seed=seed)
    assert records(ours, roots["port"]) == records(theirs, roots["jax"])
    assert (ours.classnames, ours.template, ours.name, ours.num_classes) == \
        (theirs.classnames, theirs.template, theirs.name, theirs.num_classes)
    assert len(ours.train_x) == ours.num_classes * shots


def test_mat_reader_reads_scipy_files_as_jax_does(tmp_path):
    import scipy.io

    path = str(tmp_path / "m.mat")
    scipy.io.savemat(path, {
        "labels": np.arange(1, 7)[None, :],
        "grid": np.arange(12, dtype=np.float32).reshape(3, 4),
        "name": "Acura RL Sedan 2012",
        "names": np.array(["ab", "cd"], dtype=object),
        "annotations": np.array([(np.uint8(3), "00001.jpg"), (np.uint8(1), "00002.jpg")],
                                dtype=[("class", "O"), ("fname", "O")]),
    })
    ours, theirs = mat.load_mat(path), jmat.load_mat(path)
    assert ours.keys() == theirs.keys()
    for key in theirs:
        a, b = ours[key], theirs[key]
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        elif key == "annotations":
            assert [(int(mat.mat_scalar(x["class"])), x["fname"]) for x in a] == \
                [(int(jmat.mat_scalar(x["class"])), x["fname"]) for x in b] == \
                [(3, "00001.jpg"), (1, "00002.jpg")]
        else:
            assert a == b
    np.testing.assert_array_equal(mat.mat_1d(ours["labels"]), np.arange(1, 7))


def test_rrc_boxes_match_jax():
    for seed in range(50):
        w, h = random.Random(seed).randint(8, 400), random.Random(-seed).randint(8, 400)
        ours = transforms.sample_rrc_box(w, h, random.Random(seed))
        theirs = jtransforms.sample_rrc_box(w, h, random.Random(seed))
        assert ours == theirs
    # the clamped centre fallback of a very wide image
    assert transforms.sample_rrc_box(400, 10, random.Random(0), scale=(0.99, 1.0)) == \
        jtransforms.sample_rrc_box(400, 10, random.Random(0), scale=(0.99, 1.0))
    img = Image.fromarray(np.random.default_rng(0).integers(0, 256, (37, 51, 3), dtype=np.uint8))
    np.testing.assert_array_equal(
        np.asarray(transforms.random_resized_crop(img, 24, random.Random(5))),
        np.asarray(jtransforms.random_resized_crop(img, 24, random.Random(5))))


@pytest.mark.parametrize("kind", ["eval", "train", "train_shuffled"])
def test_batch_loader_batches_are_byte_identical_to_jax(tmp_path, kind):
    rng = np.random.default_rng(1)
    items_port, items_jax = [], []
    for i in range(11):
        path = str(tmp_path / f"{i}.png")
        write_image(path, rng, size=(int(rng.integers(20, 60)), int(rng.integers(20, 60))))
        items_port.append(Datum(path, i % 4, f"c{i % 4}"))
        items_jax.append(JaxDatum(path, i % 4, f"c{i % 4}"))
    n_px = 16
    train = kind != "eval"
    kw = dict(batch_size=4, shuffle=kind == "train_shuffled", seed=3, num_threads=3,
              image_size=n_px)
    ours = loader.BatchLoader(items_port, transform=(transforms.TrainTransform if train
                                                     else transforms.EvalTransform)(n_px), **kw)
    theirs = jloader.BatchLoader(items_jax, transform=(jtransforms.TrainTransform if train
                                                       else jtransforms.EvalTransform)(n_px), **kw)
    assert len(ours) == len(theirs) == 3
    for epoch in range(2):  # a second pass draws new crops, the same in both
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 3
        for (gi, gl, gn), (wi, wl, wn) in zip(got, want):
            assert gi.dtype == np.uint8 and gi.shape == (4, n_px, n_px, 3)
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
            assert gn == wn
        assert got[-1][2] == 3 and not got[-1][0][3:].any()  # the padded tail
    with pytest.raises(ValueError):
        loader.BatchLoader([])


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*.yml"))),
                         ids=os.path.basename)
def test_load_config_matches_jax_on_every_config(path):
    ours = config.load_config(path)
    theirs = jconfig.load_config(path)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.cache_dir == theirs.cache_dir


def test_config_overrides_and_validation_match_jax():
    path = os.path.join(REPO, "configs", "fewsol_198.yml")
    ours = config.load_config(path, alpha=0.0, shots=4, only_test=True)
    assert ours.to_dict() == jconfig.load_config(path, alpha=0.0, shots=4,
                                                 only_test=True).to_dict()
    assert ours.alpha == 0.0 and ours.cache_dir.endswith(os.path.join("caches", "fewsol"))
    with pytest.raises(TypeError):
        config.load_config(path, alhpa=0.1)
    for bad in (dict(adapter="mlp"), dict(losses=["L9"]), dict(shots=0), dict(alpha=2.0),
                dict(beta=0.0), dict(compute_dtype="fp8"), dict(snapshot_every=-1),
                dict(top_k=0)):
        with pytest.raises(ValueError):
            config.Config(dataset="dtd", **bad).validate()
    for name in ("caltech101", "fewsol_198", "nope"):
        assert config.search_scale_step(name) == jconfig.search_scale_step(name)
