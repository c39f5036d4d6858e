"""Split-file readers shared by the dataset adapters (a copy of
``protoclip_tpu/data/splits.py``).

- CoOp-style ``split_zhou_*.json`` files: ``{train|val|test: [[relpath,
  label, classname], ...]}`` (ref ``datasets/oxford_pets.py:107-127``).
- Folder-per-class splitters for datasets distributed without split files
  (ref ``datasets/dtd.py:33-86``).
"""

from __future__ import annotations

import json
import os
import random as _random
from typing import Dict, List, Optional, Sequence, Tuple

from protoclip_tpu_torch.data.types import Datum


def read_split(
    filepath: str, path_prefix: str
) -> Tuple[List[Datum], List[Datum], List[Datum]]:
    """Read a CoOp split JSON into (train, val, test) Datum lists."""
    with open(filepath, "r") as fh:
        split = json.load(fh)

    def convert(rows) -> List[Datum]:
        return [
            Datum(
                impath=os.path.join(path_prefix, impath),
                label=int(label),
                classname=classname,
            )
            for impath, label, classname in rows
        ]

    return convert(split["train"]), convert(split["val"]), convert(split["test"])


def save_split(
    train: Sequence[Datum],
    val: Sequence[Datum],
    test: Sequence[Datum],
    filepath: str,
    path_prefix: str,
) -> None:
    """Write a CoOp-format split JSON (relative impaths)."""

    def extract(items):
        out = []
        for item in items:
            rel = item.impath
            if rel.startswith(path_prefix):
                rel = rel[len(path_prefix) :].lstrip("/")
            out.append((rel, item.label, item.classname))
        return out

    os.makedirs(os.path.dirname(filepath) or ".", exist_ok=True)
    with open(filepath, "w") as fh:
        json.dump(
            {"train": extract(train), "val": extract(val), "test": extract(test)},
            fh,
            indent=4,
            separators=(",", ": "),
        )


def listdir_nohidden(path: str, sort: bool = False) -> List[str]:
    """Non-hidden entries (ref ``datasets/utils.py:57-68``).

    Deliberate deviation: the reference additionally drops every name
    containing the substring ``'sh'`` — presumably to skip stray ``*.sh``
    scripts — but its only call site is DTD split *generation*
    (``datasets/dtd.py:47,69``), where that filter silently deletes the
    real DTD classes ``crosshatched`` and ``meshed`` and persists a
    45-class split.  We filter only dotfiles; shell scripts are excluded
    by the extension check below instead."""
    items = [f for f in os.listdir(path) if not f.startswith(".")]
    if sort:
        items.sort()
    return items


_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".tif", ".tiff", ".webp")


def read_and_split_folder_dataset(
    image_dir: str,
    p_trn: float = 0.5,
    p_val: float = 0.2,
    ignored: Sequence[str] = (),
    new_cnames: Optional[Dict[str, str]] = None,
    seed: Optional[int] = None,
) -> Tuple[List[Datum], List[Datum], List[Datum]]:
    """Split an ``images/<class>/*`` tree into train/val/test
    (ref ``datasets/dtd.py:33-86``)."""
    rng = _random.Random(seed) if seed is not None else _random
    categories = sorted(
        c
        for c in listdir_nohidden(image_dir)
        if c not in ignored and os.path.isdir(os.path.join(image_dir, c))
    )

    train: List[Datum] = []
    val: List[Datum] = []
    test: List[Datum] = []
    for label, category in enumerate(categories):
        cat_dir = os.path.join(image_dir, category)
        images = [
            os.path.join(cat_dir, im)
            for im in listdir_nohidden(cat_dir)
            if im.lower().endswith(_IMAGE_EXTS)
        ]
        rng.shuffle(images)
        n_total = len(images)
        n_train = round(n_total * p_trn)
        n_val = round(n_total * p_val)
        if n_train <= 0 or n_val <= 0 or n_total - n_train - n_val <= 0:
            raise ValueError(f"class {category!r} too small to split ({n_total} images)")
        cname = (new_cnames or {}).get(category, category)
        train.extend(Datum(im, label, cname) for im in images[:n_train])
        val.extend(Datum(im, label, cname) for im in images[n_train : n_train + n_val])
        test.extend(Datum(im, label, cname) for im in images[n_train + n_val :])
    return train, val, test
