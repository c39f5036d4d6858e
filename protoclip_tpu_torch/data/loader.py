"""Batch loaders (counterpart of ``protoclip_tpu/data/loader.py``).

``BatchLoader`` decodes and transforms dataset items in a thread pool (PIL
releases the GIL while it decodes and resizes) and yields fixed-shape uint8
batches; ``ArrayLoader`` batches arrays already in memory.  Both yield
``(images_u8 (B, H, W, 3), labels (B,), n_valid)``.  ``BatchLoader`` fills
a zeroed ``batch_size`` buffer, so its ragged last batch carries zero rows
past ``n_valid``; ``ArrayLoader`` yields its ragged last batch at its own
size unless ``pad_last``.
"""

from __future__ import annotations

import concurrent.futures as _futures
import random as _random
from typing import Iterator, Sequence, Tuple

import numpy as np

from protoclip_tpu_torch.data.transforms import EvalTransform, load_image
from protoclip_tpu_torch.data.types import Datum
from protoclip_tpu_torch.obs.profiler import span


class BatchLoader:
    """Iterate ``(images_u8, labels, n_valid)`` batches over dataset items.

    ``transform(PIL image, rng) -> uint8 HWC``; ``shuffle`` reorders each
    epoch from ``seed + epoch``.  The order and every image's random draws
    are functions of ``(seed, epoch, position)`` alone, as in the JAX
    package (``loader.py:89-97``): image ``p`` of the epoch draws from
    ``Random((seed * 100003 + epoch) * 1_000_003 + p)``.  So neither thread
    timing nor the package changes a batch: the same items and seed give
    the same bytes in both.
    """

    def __init__(self, items: Sequence[Datum], batch_size: int = 256, transform=None,
                 shuffle: bool = False, seed: int = 1, num_threads: int = 8,
                 image_size: int = 224):
        if len(items) == 0:
            raise ValueError("BatchLoader requires a non-empty item list")
        self.items = list(items)
        self.batch_size = batch_size
        self.transform = transform or EvalTransform(image_size)
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = max(1, num_threads)
        self.image_size = image_size
        self._epoch = 0

    def __len__(self) -> int:
        return (len(self.items) + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        """Pin the epoch that seeds the shuffle and the per-image draws: a
        resumed run (``train/resume.py``) that calls this replays the
        batches an uninterrupted run would see."""
        self._epoch = int(epoch)

    @property
    def num_items(self) -> int:
        return len(self.items)

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.items))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
        order = self._order()
        rng_base = self.seed * 100003 + self._epoch
        self._epoch += 1
        bs = self.batch_size

        def load_one(args):
            pos, global_pos, idx = args
            item = self.items[idx]
            rng = _random.Random(rng_base * 1_000_003 + global_pos)
            return pos, self.transform(load_image(item.impath), rng), item.label

        def build_batch(pool, start):
            chunk = order[start:start + bs]
            images = np.zeros((bs, self.image_size, self.image_size, 3), np.uint8)
            labels = np.zeros((bs,), np.int32)
            work = [(pos, start + pos, idx) for pos, idx in enumerate(chunk)]
            for pos, img, label in pool.map(load_one, work):
                images[pos] = img
                labels[pos] = label
            return images, labels, len(chunk)

        # the next batch decodes while the consumer encodes this one; the
        # batch assembly has its own thread, so a one-thread decode pool
        # cannot deadlock on it
        with _futures.ThreadPoolExecutor(max_workers=self.num_threads) as pool, \
                _futures.ThreadPoolExecutor(max_workers=1) as producer:
            starts = list(range(0, len(order), bs))
            pending = producer.submit(build_batch, pool, starts[0])
            for i in range(len(starts)):
                batch = pending.result()
                if i + 1 < len(starts):
                    pending = producer.submit(build_batch, pool, starts[i + 1])
                yield batch


class ArrayLoader:
    """Iterate ``(images_u8 (B, H, W, 3), labels (B,), n_valid)`` batches
    over arrays in memory, in order, each a view of the arrays.

    The ragged last batch is the view of its ``n_valid`` rows.  ``pad_last``
    zero-pads it to ``batch_size`` in a fresh copy (span ``loader.pad``), as
    the JAX package does by default: XLA compiles one program per shape, so
    it pads to keep one.  The port compiles nothing per shape and the bank
    build keeps only the valid rows, so it pads only when asked."""

    shuffle = False

    def __init__(self, images: np.ndarray, labels: np.ndarray, batch_size: int = 256,
                 pad_last: bool = False):
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
                with span("loader.pad", rows=bs - n_valid) as pad:
                    imgs = np.concatenate([imgs, np.zeros((bs - n_valid, *imgs.shape[1:]),
                                                          imgs.dtype)])
                    labs = np.concatenate([labs, np.zeros((bs - n_valid,), labs.dtype)])
                    pad.nbytes = imgs.nbytes
            yield imgs, labs, n_valid
