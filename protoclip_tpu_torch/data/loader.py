"""In-memory batch loader (counterpart of ``ArrayLoader`` in
``protoclip_tpu/data/loader.py``; the threaded file loader comes with the
host data-path slice)."""

from __future__ import annotations

import numpy as np


class ArrayLoader:
    """Iterate ``(images_u8 (B, H, W, 3), labels (B,), n_valid)`` batches
    over arrays in memory, in order; the ragged last batch is zero-padded
    to ``batch_size`` when ``pad_last``."""

    shuffle = False

    def __init__(self, images: np.ndarray, labels: np.ndarray, batch_size: int = 256,
                 pad_last: bool = True):
        if len(images) != len(labels):
            raise ValueError(f"{len(images)} images but {len(labels)} labels")
        self.images = images
        self.labels = labels
        self.batch_size = batch_size
        self.pad_last = pad_last

    def __len__(self) -> int:
        return (len(self.images) + self.batch_size - 1) // self.batch_size

    @property
    def num_items(self) -> int:
        return len(self.images)

    def __iter__(self):
        bs = self.batch_size
        for start in range(0, len(self.images), bs):
            imgs = self.images[start:start + bs]
            labs = self.labels[start:start + bs]
            n_valid = len(imgs)
            if self.pad_last and n_valid < bs:
                imgs = np.concatenate([imgs, np.zeros((bs - n_valid, *imgs.shape[1:]), imgs.dtype)])
                labs = np.concatenate([labs, np.zeros((bs - n_valid,), labs.dtype)])
            yield imgs, labs, n_valid
