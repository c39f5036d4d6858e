"""Dataset registry: 12 benchmark adapters behind one ``build_dataset``
(a copy of ``protoclip_tpu/data/registry.py``).

Mirrors the reference's registry surface (``datasets/__init__.py:14-30``,
plus ImageNet handled separately in ``main.py:508-515``), but adapters are
data-driven specs instead of one class per file: every CoOp-style dataset is
(directory, image subdir, split JSON, prompt template).  Special cases:
FGVC (txt annotation files), ImageNet (class-folder tree + curated CLIP
classnames), FewSOL-198 (alternate split file shipped with Proto-CLIP).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional

from protoclip_tpu_torch.data.splits import read_split, save_split
from protoclip_tpu_torch.data.types import Datum, FewShotDataset, generate_fewshot

_ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")


@dataclasses.dataclass(frozen=True)
class _JsonSpec:
    """A CoOp-style dataset: split JSON + image dir + one prompt template."""

    dataset_dir: str
    image_subdir: str
    split_file: str
    template: List[str]


# Directory names, split files and templates established by the reference
# adapters (datasets/<name>.py, one template per dataset).
_JSON_SPECS: Dict[str, _JsonSpec] = {
    "caltech101": _JsonSpec(
        "caltech-101", "101_ObjectCategories", "split_zhou_Caltech101.json",
        ["a photo of a {}."],
    ),
    "dtd": _JsonSpec(
        "dtd", "images", "split_zhou_DescribableTextures.json", ["{} texture."]
    ),
    "eurosat": _JsonSpec(
        "eurosat", "2750", "split_zhou_EuroSAT.json",
        ["a centered satellite photo of {}."],
    ),
    "food101": _JsonSpec(
        "food-101", "images", "split_zhou_Food101.json",
        ["a photo of {}, a type of food."],
    ),
    "oxford_flowers": _JsonSpec(
        "oxford_flowers", "jpg", "split_zhou_OxfordFlowers.json",
        ["a photo of a {}, a type of flower."],
    ),
    "oxford_pets": _JsonSpec(
        "oxford_pets", "images", "split_zhou_OxfordPets.json",
        ["a photo of a {}, a type of pet."],
    ),
    "stanford_cars": _JsonSpec(
        "stanford_cars", "", "split_zhou_StanfordCars.json", ["a photo of a {}."]
    ),
    "sun397": _JsonSpec(
        "sun397", "SUN397", "split_zhou_SUN397.json", ["a photo of a {}."]
    ),
    "ucf101": _JsonSpec(
        "ucf101", "UCF-101-midframes", "split_zhou_UCF101.json",
        ["a photo of a person doing {}."],
    ),
    "fewsol": _JsonSpec("fewsol", "data", "fewsol_splits.json", ["a photo of a {}"]),
}

# Alternate split files for FewSOL-198 (ref splits/fewsol_splits_198.json;
# configs/fewsol_198.yml runs dataset 'fewsol' against the 198-class split).
# Candidates: the dataset dir, then a repo-checkout splits/ dir; anything
# else comes in via $PROTOCLIP_FEWSOL198_SPLIT (a shipped package must not
# hardcode machine-specific paths).
_FEWSOL_198_CANDIDATES = (
    "fewsol_splits_198.json",  # inside the dataset dir
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "splits", "fewsol_splits_198.json"),
)


def _build_json_dataset(
    alias: str, root: str, shots: int, seed: int, split_path: Optional[str] = None
) -> FewShotDataset:
    spec = _JSON_SPECS[alias]
    dataset_dir = os.path.join(root, spec.dataset_dir)
    image_dir = os.path.join(dataset_dir, spec.image_subdir) if spec.image_subdir else dataset_dir
    split_path = split_path or os.path.join(dataset_dir, spec.split_file)
    if not os.path.exists(split_path):
        # Generate the split from raw dataset metadata (folder tree or devkit
        # .mat files) and persist it, as the original CoOp tooling did — the
        # reference requires the JSON to pre-exist (datasets/dtd.py:33-86,
        # oxford_flowers.py:38-74, stanford_cars.py:28-50, eurosat.py:9-52).
        from protoclip_tpu_torch.data.builders import SPLIT_BUILDERS

        builder = SPLIT_BUILDERS.get(alias)
        if builder is None:
            raise FileNotFoundError(
                f"{split_path} not found and dataset {alias!r} has no split builder"
            )
        train, val, test = builder(dataset_dir, image_dir, seed)
        save_split(train, val, test, split_path, image_dir)
    train, val, test = read_split(split_path, image_dir)
    train = generate_fewshot(train, shots, seed=seed)
    return FewShotDataset(train, val, test, spec.template, name=alias)


def _build_fewsol_198(root: str, shots: int, seed: int) -> FewShotDataset:
    dataset_dir = os.path.join(root, "fewsol")
    candidates = _FEWSOL_198_CANDIDATES
    env_path = os.environ.get("PROTOCLIP_FEWSOL198_SPLIT")
    if env_path:
        # abspath: a relative env path is the user's CWD-relative intent —
        # without this it would pass the existence check below (CWD) but be
        # resolved against dataset_dir in the candidate loop, silently
        # falling through to a default split
        env_path = os.path.abspath(env_path)
        if not os.path.exists(env_path):
            # fail loudly like bpe.default_vocab_path: silently falling
            # through to another candidate would benchmark the wrong split
            raise FileNotFoundError(
                f"$PROTOCLIP_FEWSOL198_SPLIT points at {env_path!r}, which "
                "does not exist"
            )
        candidates = (env_path,) + candidates
    for cand in candidates:
        path = cand if os.path.isabs(cand) else os.path.join(dataset_dir, cand)
        if os.path.exists(path):
            ds = _build_json_dataset("fewsol", root, shots, seed, split_path=path)
            return FewShotDataset(ds.train_x, ds.val, ds.test, ds.template, name="fewsol_198")
    raise FileNotFoundError(
        "fewsol_splits_198.json not found (set $PROTOCLIP_FEWSOL198_SPLIT or "
        "place it in the dataset dir / repo splits/)"
    )


def _build_fgvc(root: str, shots: int, seed: int) -> FewShotDataset:
    """FGVC Aircraft via variants.txt + images_variant_<split>.txt
    (ref ``datasets/fgvc.py:10-53``)."""
    dataset_dir = os.path.join(root, "fgvc_aircraft")
    image_dir = os.path.join(dataset_dir, "images")
    with open(os.path.join(dataset_dir, "variants.txt")) as fh:
        classnames = [line.strip() for line in fh if line.strip()]
    cname2lab = {c: i for i, c in enumerate(classnames)}

    def read(split_file: str) -> List[Datum]:
        items = []
        with open(os.path.join(dataset_dir, split_file)) as fh:
            for line in fh:
                parts = line.strip().split(" ")
                if not parts or not parts[0]:
                    continue
                imname, classname = parts[0] + ".jpg", " ".join(parts[1:])
                items.append(
                    Datum(os.path.join(image_dir, imname), cname2lab[classname], classname)
                )
        return items

    train = generate_fewshot(read("images_variant_train.txt"), shots, seed=seed)
    return FewShotDataset(
        train,
        read("images_variant_val.txt"),
        read("images_variant_test.txt"),
        ["a photo of a {}, a type of aircraft."],
        name="fgvc",
    )


def imagenet_classnames_and_templates():
    """The curated CLIP classname list + 7-template prompt ensemble
    (data asset; ref ``datasets/imagenet.py:26-199``)."""
    with open(os.path.join(_ASSETS, "imagenet_clip.json")) as fh:
        data = json.load(fh)
    return data["classnames"], data["templates"]


def _imagenet_flat_val(
    val_dir: str, dataset_dir: str, classnames
) -> List[Datum]:
    """The standard ILSVRC2012 val download is FLAT (no wnid folders); label
    it via the devkit metadata exactly as torchvision does
    (ref ``datasets/imagenet.py:216-219`` via ``torchvision.datasets.ImageNet``):
    ``ILSVRC2012_validation_ground_truth.txt`` gives the 1-based ILSVRC id of
    the i-th val image (sorted by filename); ``meta.mat`` maps ids to wnids;
    labels are indices into the lexicographically sorted wnid list."""
    from protoclip_tpu_torch.io.mat import load_mat, mat_scalar

    devkit = None
    for base in (dataset_dir, os.path.join(dataset_dir, "images")):
        cand = os.path.join(base, "ILSVRC2012_devkit_t12")
        if os.path.isdir(cand):
            devkit = cand
            break
    if devkit is None:
        raise FileNotFoundError(
            f"{val_dir} has no <wnid>/ subfolders and no ILSVRC2012_devkit_t12/ "
            "was found to label the flat layout"
        )
    synsets = load_mat(os.path.join(devkit, "data", "meta.mat"))["synsets"]
    id2wnid = {}
    for s in synsets:
        ilsvrc_id = int(mat_scalar(s["ILSVRC2012_ID"]))
        if ilsvrc_id <= 1000:  # leaf classes only (ids >1000 are internal nodes)
            id2wnid[ilsvrc_id] = str(s["WNID"])
    wnid2label = {w: i for i, w in enumerate(sorted(id2wnid.values()))}
    with open(
        os.path.join(devkit, "data", "ILSVRC2012_validation_ground_truth.txt")
    ) as fh:
        gt = [int(line) for line in fh if line.strip()]
    files = sorted(f for f in os.listdir(val_dir) if not f.startswith("."))
    if len(files) != len(gt):
        raise ValueError(
            f"{len(files)} val images but {len(gt)} ground-truth labels"
        )
    items = []
    for fname, ilsvrc_id in zip(files, gt):
        label = wnid2label[id2wnid[ilsvrc_id]]
        cname = classnames[label] if label < len(classnames) else id2wnid[ilsvrc_id]
        items.append(Datum(os.path.join(val_dir, fname), label, cname))
    return items


def _build_imagenet(root: str, shots: int, seed: int) -> FewShotDataset:
    """ImageNet from a class-folder tree, or the standard flat-val download.

    Expects ``<root>/imagenet/images/{train,val}``; ``train/<wnid>/*`` always,
    ``val`` either as ``<wnid>/`` folders or flat with the devkit extracted
    alongside.  wnids sorted lexicographically define labels 0..999
    (torchvision's convention).  Val doubles as test, as in the reference
    (``datasets/imagenet.py:216-219``).
    """
    classnames, templates = imagenet_classnames_and_templates()
    dataset_dir = os.path.join(root, "imagenet")
    image_dir = os.path.join(dataset_dir, "images")

    def scan(split: str) -> List[Datum]:
        split_dir = os.path.join(image_dir, split)
        wnids = sorted(
            d for d in os.listdir(split_dir) if os.path.isdir(os.path.join(split_dir, d))
        )
        if not wnids and split == "val":
            return _imagenet_flat_val(split_dir, dataset_dir, classnames)
        items = []
        for label, wnid in enumerate(wnids):
            cname = classnames[label] if label < len(classnames) else wnid
            wdir = os.path.join(split_dir, wnid)
            for fname in sorted(os.listdir(wdir)):
                # skip hidden/sidecar files (.DS_Store etc.) — PIL would
                # abort the feature pass decoding them (same filter as
                # _imagenet_flat_val)
                if fname.startswith("."):
                    continue
                items.append(Datum(os.path.join(wdir, fname), label, cname))
        return items

    train = generate_fewshot(scan("train"), shots, seed=seed)
    val = scan("val")
    return FewShotDataset(train, val, val, templates, name="imagenet")


_BUILDERS: Dict[str, Callable[[str, int, int], FewShotDataset]] = {
    **{
        alias: (lambda a: lambda root, shots, seed: _build_json_dataset(a, root, shots, seed))(alias)
        for alias in _JSON_SPECS
    },
    "fgvc": _build_fgvc,
    "imagenet": _build_imagenet,
    "fewsol_198": _build_fewsol_198,
}


def available_datasets() -> List[str]:
    return sorted(_BUILDERS)


def build_dataset(alias: str, root: str, shots: int, seed: int = 1) -> FewShotDataset:
    """Build a few-shot benchmark dataset (ref ``datasets/__init__.py:29-30``).

    ``seed`` pins the K-shot subsample (the reference seeds the global RNG with
    1 before sampling, ``main.py:499-503``).
    """
    if alias not in _BUILDERS:
        raise KeyError(f"unknown dataset {alias!r}; available: {available_datasets()}")
    return _BUILDERS[alias](root, shots, seed)
