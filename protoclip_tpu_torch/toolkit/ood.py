"""Out-of-distribution evaluation (counterpart of
``protoclip_tpu/toolkit/ood.py``; ref ``toolkit/.../ood_utils.py:26-110``):
score a trained ImageNet Proto-CLIP checkpoint on ImageNetV2 /
ImageNet-Sketch style class-folder datasets.  The features are cached under
the JAX package's stems (``ood_<name>``), so either package reads the
other's cache."""

from __future__ import annotations

import os
from typing import List, Optional

from protoclip_tpu_torch.core.config import Config
from protoclip_tpu_torch.core.protoclip import accuracy, from_arrays
from protoclip_tpu_torch.data.loader import BatchLoader
from protoclip_tpu_torch.data.splits import _IMAGE_EXTS, listdir_nohidden
from protoclip_tpu_torch.data.transforms import EvalTransform
from protoclip_tpu_torch.data.types import Datum
from protoclip_tpu_torch.device import DeviceLike, resolve_device
from protoclip_tpu_torch.io.checkpoint import load_checkpoint_triple
from protoclip_tpu_torch.memory import FeatureCache, pre_load_features
from protoclip_tpu_torch.models.adapters import adapter_from_torch_state


def class_folder_items(root_dir: str) -> List[Datum]:
    """Scan ``root/<class>/*`` into Datum rows; classes sorted
    lexicographically (torchvision ``ImageFolder`` convention, matching both
    ImageNetV2 and ImageNet-Sketch layouts)."""
    classes = sorted(
        d for d in os.listdir(root_dir) if os.path.isdir(os.path.join(root_dir, d))
    )
    items: List[Datum] = []
    for label, cls in enumerate(classes):
        cls_dir = os.path.join(root_dir, cls)
        for fname in _image_files(cls_dir):
            items.append(Datum(os.path.join(cls_dir, fname), label, cls))
    return items


def _image_files(cls_dir: str) -> List[str]:
    # hidden/non-image entries (.DS_Store, READMEs) must not become Datum
    # rows — PIL would abort the whole eval decoding them
    return [
        f for f in listdir_nohidden(cls_dir, sort=True)
        if f.lower().endswith(_IMAGE_EXTS)
    ]


def imagenet_v2_items(root_dir: str) -> List[Datum]:
    """ImageNetV2 layout: folders named by *numeric* class id."""
    classes = sorted(
        (d for d in os.listdir(root_dir) if os.path.isdir(os.path.join(root_dir, d))),
        key=lambda name: int(name),
    )
    items: List[Datum] = []
    for cls in classes:
        label = int(cls)
        cls_dir = os.path.join(root_dir, cls)
        for fname in _image_files(cls_dir):
            items.append(Datum(os.path.join(cls_dir, fname), label, cls))
    return items


def test_ood_performance(
    cfg: Config,
    test_dataset_name: str,
    encode_fn,
    data_root: str,
    memory_bank_v_path: Optional[str] = None,
    memory_bank_t_path: Optional[str] = None,
    adapter_weights_path: Optional[str] = None,
    image_size: int = 224,
    cache: Optional[FeatureCache] = None,
    device: DeviceLike = None,
) -> float:
    """Accuracy (%) of a trained checkpoint on an OOD test set, with the
    classifier on ``device`` (default: the card).

    ``test_dataset_name``: ``imagenet_v2`` (numeric class folders) or
    ``imagenet_sketch`` (wnid class folders).
    """
    dev = resolve_device(device)
    if test_dataset_name == "imagenet_v2":
        items = imagenet_v2_items(data_root)
    elif test_dataset_name == "imagenet_sketch":
        items = class_folder_items(data_root)
    else:
        raise ValueError(f"unknown OOD dataset {test_dataset_name!r}")

    loader = BatchLoader(
        items, batch_size=cfg.batch_size, transform=EvalTransform(image_size),
        image_size=image_size,
    )
    feats, labels = pre_load_features(
        encode_fn, loader, f"ood_{test_dataset_name}", cache,
        expected_count=len(items),
    )

    bank_v, bank_t, adapter_state = load_checkpoint_triple(
        memory_bank_v_path, memory_bank_t_path, adapter_weights_path
    )
    model = from_arrays(
        bank_v,
        bank_t,
        adapter_from_torch_state(adapter_state, cfg.adapter) if adapter_state else {},
        cfg.adapter,
        cfg.shots,
        device=dev,
    )
    return accuracy(model, feats, labels, cfg.alpha, cfg.beta) * 100.0
