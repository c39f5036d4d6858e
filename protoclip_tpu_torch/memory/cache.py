"""On-disk feature caches, directory-compatible with the reference and with
the JAX package (counterpart of ``protoclip_tpu/memory/cache.py``).

The reference caches every expensive stage under
``caches/<dataset>/models/<backbone>/K-<shots>/`` (``utils.py:280-332``):

- ``aug/visual_mb_{keys,values}_aug_{A}_{K}_shots.pt``
- ``text_mb_<backbone>_K_<shots>.pkl``
- ``{val,test}_{features,labels}.pt``

This cache keeps the same tree and stem names and stores ``.npz``, which
both packages write and read.  Where an ``.npz`` is absent it also reads the
reference's own files: ``.pt`` through ``torch.load(weights_only=True)``,
and the raw pickles (``text_mb_*.pkl`` textual banks, the
``zero_shot_hp_search_*.pkl`` grids) through a restricted unpickler that
maps their CUDA storages to the CPU.
"""

from __future__ import annotations

import os
import sys
import time
import uuid
import zipfile
from typing import Dict, Optional

import numpy as np

from protoclip_tpu_torch.io.checkpoint import beautify, load_pkl, load_pt, model_dir_root


class FeatureCache:
    """Cache handle for one (dataset, backbone, shots) operating point."""

    def __init__(self, cache_dir: str, backbone: str, shots: int):
        self.root = model_dir_root(cache_dir, backbone, shots)
        self.backbone = backbone
        self.shots = shots
        self._sweep_stale_tmp()

    def _sweep_stale_tmp(self, max_age_s: float = 3600.0) -> None:
        """Remove ``*.tmp-<pid>-<rand>`` files that a crashed writer left;
        a live writer's tmp file is younger than ``max_age_s`` and stays."""
        if not os.path.isdir(self.root):
            return
        cutoff = time.time() - max_age_s
        for dirpath, _, names in os.walk(self.root):
            for name in names:
                if ".tmp-" not in name:
                    continue
                path = os.path.join(dirpath, name)
                try:
                    if os.path.getmtime(path) < cutoff:
                        os.remove(path)
                except OSError:
                    pass  # raced with another sweeper or a live writer

    def _npz_path(self, stem: str) -> str:
        return os.path.join(self.root, f"{stem}.npz")

    def load(self, stem: str) -> Optional[Dict[str, np.ndarray]]:
        path = self._npz_path(stem)
        if os.path.exists(path):
            try:
                with np.load(path) as data:
                    return {k: data[k] for k in data.files}
            except (zipfile.BadZipFile, ValueError, EOFError) as exc:
                # a truncated archive must cause a rebuild, not a permanent crash
                print(f"[protoclip_tpu_torch] corrupt cache entry {path} ({exc}); "
                      "discarding and recomputing", file=sys.stderr)
                os.remove(path)
        for ext, reader in (("pt", load_pt), ("pkl", load_pkl)):
            ref_path = os.path.join(self.root, f"{stem}.{ext}")
            if os.path.exists(ref_path):
                return self._wrap(reader(ref_path))
        return None

    @staticmethod
    def _wrap(obj) -> Dict[str, np.ndarray]:
        if isinstance(obj, dict):
            return {k: np.asarray(v) for k, v in obj.items()}
        return {"array": np.asarray(obj)}

    def save(self, stem: str, **arrays: np.ndarray) -> None:
        """Write ``<stem>.npz`` through a per-writer tmp file and a rename:
        a crash leaves no truncated archive, and two runs that share a tree
        never write into one tmp file."""
        path = self._npz_path(stem)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        try:
            with open(tmp, "wb") as fh:  # a file handle: savez must not append .npz
                np.savez(fh, **arrays)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass

    # -- named artifacts (the reference's stems) ----------------------------

    def visual_bank_stems(self, augment_epochs: int):
        return (
            f"aug/visual_mb_keys_aug_{augment_epochs}_{self.shots}_shots",
            f"aug/visual_mb_values_aug_{augment_epochs}_{self.shots}_shots",
        )

    def text_bank_stem(self) -> str:
        return f"text_mb_{beautify(self.backbone)}_K_{self.shots}"

    def split_stems(self, split: str):
        return f"{split}_features", f"{split}_labels"

    def hp_search_stem(self, split: str) -> str:
        return f"zero_shot_hp_search_{split}_{beautify(self.backbone)}_K_{self.shots}"
