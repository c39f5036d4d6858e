"""Generate-if-missing split builders for datasets distributed without
CoOp ``split_zhou_*.json`` files (a copy of ``protoclip_tpu/data/builders.py``).

The reference repo requires the split JSONs to pre-exist, but the upstream
dataset downloads don't ship them; the original CoOp tooling generated them
once from raw metadata.  These builders reproduce that construction so a
user pointing at a fresh dataset download gets a working (and persisted)
split:

- DTD: 50/20/30 folder split (ref ``datasets/dtd.py:33-86``)
- EuroSAT: folder split + display-name remap (ref ``datasets/eurosat.py:9-52``)
- Oxford-Flowers: ``imagelabels.mat`` + ``cat_to_name.json``
  (ref ``datasets/oxford_flowers.py:38-74``)
- Stanford-Cars: devkit ``.mat`` annotations
  (ref ``datasets/stanford_cars.py:28-50``)
"""

from __future__ import annotations

import json
import os
import random
from collections import defaultdict
from typing import Dict, List, Tuple

from protoclip_tpu_torch.data.splits import read_and_split_folder_dataset
from protoclip_tpu_torch.data.types import Datum

Split = Tuple[List[Datum], List[Datum], List[Datum]]

# EuroSAT folder name -> prompt classname (ref datasets/eurosat.py:9-20)
EUROSAT_NEW_CNAMES: Dict[str, str] = {
    "AnnualCrop": "Annual Crop Land",
    "Forest": "Forest",
    "HerbaceousVegetation": "Herbaceous Vegetation Land",
    "Highway": "Highway or Road",
    "Industrial": "Industrial Buildings",
    "Pasture": "Pasture Land",
    "PermanentCrop": "Permanent Crop Land",
    "Residential": "Residential Buildings",
    "River": "River",
    "SeaLake": "Sea or Lake",
}


def build_dtd_split(dataset_dir: str, image_dir: str, seed: int) -> Split:
    return read_and_split_folder_dataset(image_dir, seed=seed)


def build_eurosat_split(dataset_dir: str, image_dir: str, seed: int) -> Split:
    return read_and_split_folder_dataset(
        image_dir, new_cnames=EUROSAT_NEW_CNAMES, seed=seed
    )


def build_oxford_flowers_split(dataset_dir: str, image_dir: str, seed: int) -> Split:
    """50/20/30 per-class split from ``imagelabels.mat`` + ``cat_to_name.json``
    (ref ``datasets/oxford_flowers.py:38-74``; labels are 1-based in the
    ``.mat``, images named ``image_%05d.jpg``)."""
    from protoclip_tpu_torch.io.mat import load_mat, mat_1d

    labels = mat_1d(load_mat(os.path.join(dataset_dir, "imagelabels.mat"))["labels"])
    with open(os.path.join(dataset_dir, "cat_to_name.json")) as fh:
        lab2cname = json.load(fh)

    tracker = defaultdict(list)
    for i, label in enumerate(labels):
        impath = os.path.join(image_dir, f"image_{i + 1:05d}.jpg")
        tracker[int(label)].append(impath)

    rng = random.Random(seed)
    train: List[Datum] = []
    val: List[Datum] = []
    test: List[Datum] = []
    for label, impaths in tracker.items():
        rng.shuffle(impaths)
        n_total = len(impaths)
        n_train = round(n_total * 0.5)
        n_val = round(n_total * 0.2)
        if n_train <= 0 or n_val <= 0 or n_total - n_train - n_val <= 0:
            raise ValueError(f"flower class {label} too small to split ({n_total})")
        cname = lab2cname[str(label)]
        train.extend(Datum(p, label - 1, cname) for p in impaths[:n_train])
        val.extend(Datum(p, label - 1, cname) for p in impaths[n_train : n_train + n_val])
        test.extend(Datum(p, label - 1, cname) for p in impaths[n_train + n_val :])
    return train, val, test


def _cars_classname(raw: str) -> str:
    """Move the year to the front: 'Acura RL Sedan 2012' -> '2012 Acura RL
    Sedan' (ref ``datasets/stanford_cars.py:40-43``)."""
    names = raw.split(" ")
    year = names.pop(-1)
    names.insert(0, year)
    return " ".join(names)


def _read_cars_annos(
    dataset_dir: str, image_subdir: str, anno_file: str, class_names: List[str]
) -> List[Datum]:
    from protoclip_tpu_torch.io.mat import load_mat, mat_scalar

    annos = load_mat(os.path.join(dataset_dir, anno_file))["annotations"]
    items = []
    for anno in annos:
        label = int(mat_scalar(anno["class"])) - 1  # 1-based in the .mat
        fname = anno["fname"]
        if not isinstance(fname, str):  # (R>1, C) char matrix -> list[str]
            raise ValueError(
                f"expected a single-row char fname, got {type(fname).__name__}: "
                f"{fname!r}"
            )
        items.append(
            Datum(
                os.path.join(dataset_dir, image_subdir, fname),
                label,
                _cars_classname(class_names[label]),
            )
        )
    return items


def build_stanford_cars_split(dataset_dir: str, image_dir: str, seed: int) -> Split:
    """Train/val from the devkit train annotations (80/20 per class), test
    from ``cars_test_annos_withlabels.mat`` (ref
    ``datasets/stanford_cars.py:28-50``; trainval split per CoOp convention)."""
    from protoclip_tpu_torch.io.mat import load_mat

    class_names = [
        str(c)
        for c in load_mat(os.path.join(dataset_dir, "devkit", "cars_meta.mat"))[
            "class_names"
        ]
    ]
    trainval = _read_cars_annos(
        dataset_dir, "cars_train", os.path.join("devkit", "cars_train_annos.mat"),
        class_names,
    )
    test = _read_cars_annos(
        dataset_dir, "cars_test", "cars_test_annos_withlabels.mat", class_names
    )

    by_label = defaultdict(list)
    for item in trainval:
        by_label[item.label].append(item)
    rng = random.Random(seed)
    train: List[Datum] = []
    val: List[Datum] = []
    for label in sorted(by_label):
        items = by_label[label]
        if len(items) < 2:
            # like the sibling builders: a 1-item class would put its only
            # item in val, silently dropping the class from train and
            # desyncing the visual bank's class count from bank_t/test
            raise ValueError(
                f"stanford_cars class {items[0].classname!r} has only "
                f"{len(items)} trainval item(s); need >= 2 for a train/val split"
            )
        rng.shuffle(items)
        n_val = max(1, round(len(items) * 0.2))
        val.extend(items[:n_val])
        train.extend(items[n_val:])
    return train, val, test


# alias -> builder; consulted by the registry when the split JSON is absent
SPLIT_BUILDERS = {
    "dtd": build_dtd_split,
    "eurosat": build_eurosat_split,
    "oxford_flowers": build_oxford_flowers_split,
    "stanford_cars": build_stanford_cars_split,
}
