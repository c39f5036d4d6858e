"""Validate the full experiment path on the card, end to end (the port's
counterpart of ``scripts/validate_experiment_tpu.py``).

The tests drive the experiment runner (``train/runner.py::run``, the
analog of the reference's ``python main.py``, ref ``main.py:474-552``) on
the CPU; this script is its hardware counterpart.  It synthesizes a
caltech-101-layout dataset at real geometry (224 px JPEGs), then runs the
complete flow on the card:

  dataset build -> visual/textual memory banks (augment passes through the
  image tower) -> val/test feature pre-load -> zero-shot alpha/beta sweep
  -> episodic Proto-CLIP-F training -> best-checkpoint save -> test with
  fixed and re-searched alpha/beta -> plots/t-SNE

with the hand-written block kernels (K2) at ViT-B/32's geometry (L=50) by
default.  Weights are random-init (seed 0) unless found, so accuracy is
meaningless; what is validated is that every phase runs on the card, the
artifacts land in the reference cache layout, and the ``only_test`` reload
path reproduces the fixed-alpha/beta accuracy::

    python -m protoclip_tpu_torch.scripts.validate_experiment
    python -m protoclip_tpu_torch.scripts.validate_experiment --backbone ViT-B/16
    python -m protoclip_tpu_torch.scripts.validate_experiment --device cpu

Without ``--device cpu`` it runs on the card and raises where CUDA is
absent.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from protoclip_tpu_torch.scripts._env import ensure_bpe_vocab


def make_dataset(root: str, n_class: int = 3, n_train: int = 6, n_eval: int = 4) -> None:
    """Caltech-101-layout synthetic dataset: each class one color family,
    224 px JPEGs, split JSON in the reference schema (datasets/oxford_pets.py
    read_split rows [path, label, classname])."""
    from PIL import Image

    rng = np.random.default_rng(0)
    img_dir = os.path.join(root, "caltech-101", "101_ObjectCategories")
    rows = {"train": [], "val": [], "test": []}
    colors = [(200, 30, 30), (30, 200, 30), (30, 30, 200), (200, 200, 30)]
    names = ["redthing", "greenthing", "bluething", "yellowthing"]
    for c in range(n_class):
        cname = names[c % len(names)]
        os.makedirs(os.path.join(img_dir, cname), exist_ok=True)
        idx = 0
        for split, count in (("train", n_train), ("val", n_eval), ("test", n_eval)):
            for _ in range(count):
                rel = f"{cname}/{idx}.jpg"
                base = np.asarray(colors[c % len(colors)], np.uint8)
                noise = rng.integers(0, 50, (240, 240, 3))
                img = np.clip(base[None, None] + noise, 0, 255).astype(np.uint8)
                Image.fromarray(img).save(os.path.join(img_dir, rel), quality=92)
                rows[split].append([rel, c, cname])
                idx += 1
    with open(os.path.join(root, "caltech-101", "split_zhou_Caltech101.json"), "w") as fh:
        json.dump(rows, fh)


def describe_device(device) -> dict:
    """The device's name and, for a card, its power limit as
    ``nvidia-smi --query-gpu=name,power.limit`` reports it."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    smi = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return {"name": torch.cuda.get_device_name(index), "power_limit": smi}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--backbone", default="ViT-B/32",
                        help="any BACKBONE_CONFIGS name (random init)")
    parser.add_argument("--train_epoch", type=int, default=3)
    parser.add_argument("--shots", type=int, default=2)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    args = parser.parse_args(argv)
    ensure_bpe_vocab()

    from protoclip_tpu_torch.core.config import Config
    from protoclip_tpu_torch.device import resolve_device
    from protoclip_tpu_torch.io.checkpoint import model_dir_root
    from protoclip_tpu_torch.train.runner import run

    device = resolve_device(args.device)
    info = describe_device(device)
    print(f"[validate] backend={device.type} device={info['name']} "
          f"power_limit={info['power_limit']}")

    with tempfile.TemporaryDirectory(prefix="protoclip_exp_") as tmp:
        root = os.path.join(tmp, "DATA")
        make_dataset(root)
        cfg = Config(
            dataset="caltech101",
            root_path=root,
            shots=args.shots,
            backbone=args.backbone,
            lr=1e-3,
            augment_epoch=2,
            train_epoch=args.train_epoch,
            alpha=0.5,
            beta=5.0,
            adapter="fc",
            batch_size=16,
            cache_root=os.path.join(tmp, "caches"),
            logs_dir_path=os.path.join(tmp, "logs"),
        ).validate()

        t0 = time.time()
        result = run(cfg, progress=False, device=device)
        t_run = time.time() - t0
        print(f"[validate] full run: {t_run:.1f}s  "
              f"zero-shot={result.zero_shot.get('val_best_acc'):.3f}  "
              f"test_fixed={result.test_acc_fixed:.3f}  "
              f"test_searched={result.test_acc_searched:.3f}  "
              f"best_epoch={result.best_epoch}")

        # artifacts in the reference cache layout
        cache = model_dir_root(cfg.cache_dir, cfg.backbone, cfg.shots)
        ckpt_dir = os.path.join(cache, "alpha-beta", "0.5-5.0")
        missing = [p for p in (
            os.path.join(cache, "aug", f"visual_mb_keys_aug_2_{cfg.shots}_shots.npz"),
            os.path.join(cache, "val_features.npz"),
            ckpt_dir,
        ) if not os.path.exists(p)]
        if missing:
            print(f"[validate] FAIL: missing artifacts {missing}")
            return 1
        if not any(f.endswith("_v.pt") for f in os.listdir(ckpt_dir)):
            print(f"[validate] FAIL: no checkpoint triple in {ckpt_dir}")
            return 1

        # the only_test reload path must reproduce the fixed-point accuracy
        t0 = time.time()
        result2 = run(Config(**{**cfg.to_dict(), "only_test": True}), progress=False,
                      device=device)
        t_ot = time.time() - t0
        if abs(result2.test_acc_fixed - result.test_acc_fixed) > 1e-5:
            print(f"[validate] FAIL: only_test acc {result2.test_acc_fixed} != "
                  f"train-run acc {result.test_acc_fixed}")
            return 1
        print(f"[validate] only_test reload: {t_ot:.1f}s, acc reproduced")
        print(json.dumps({
            "backend": device.type,
            "device": info["name"],
            "power_limit": info["power_limit"],
            "backbone": args.backbone,
            "full_run_seconds": t_run,
            "only_test_seconds": t_ot,
            "test_acc_fixed": float(result.test_acc_fixed),
            "ok": True,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
