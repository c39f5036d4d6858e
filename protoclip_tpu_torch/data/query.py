"""Binned-uniform query sampler — parity for the reference's ``QueryDataset``
(counterpart of ``protoclip_tpu/data/query.py``, copied as it is: stdlib
``random`` and numpy only).

The reference ships a small synthetic dataset + loader pair at
``datasets/utils.py:397-428`` (``QueryDataset``, ``collate_fn``,
``create_dataloader``): ``n`` uniform floats laid out over ``k``
equal-width bins of ``[0, n)``, served shuffled in fp32 batches.  Nothing
in the reference calls it — it reads like scaffolding for a query-stream
experiment that never shipped — but it is part of the public surface, so
it is carried here with the same semantics, minus torch:

* generation uses the stdlib ``random`` module exactly like the reference
  (``random.uniform(bin_min, bin_max)`` per bin, bin edges from integer
  division), so under a shared seed the values are IDENTICAL item-for-item
  to the reference class (asserted by the executed-reference diff in
  ``tests/test_reference_diff.py`` for the JAX package's copy);
* batching is a plain shuffled iterator over fixed ``float32`` numpy
  arrays — the jit-friendly shape contract the rest of this framework's
  loaders use (``data/loader.py``) — instead of a torch ``DataLoader``.

Note the reference's sizing quirk, preserved here: each bin draws
``bin_max - bin_min`` samples where ``bin_max = (i + 1) * n // k``, so the
total is exactly ``n`` but bins are uneven when ``k`` does not divide ``n``
(and the LAST bin's upper edge is ``n``, giving values in ``[0, n]``
inclusive of the ``random.uniform`` closed upper bound).
"""

from __future__ import annotations

import random
from typing import Iterator, List, Optional

import numpy as np

__all__ = ["query_bin_data", "iter_query_batches"]


def query_bin_data(n: int, k: int, rng: Optional[random.Random] = None) -> List[float]:
    """The reference ``QueryDataset.__init__`` data list (``datasets/
    utils.py:398-410``): for bin ``i`` of ``k``, ``bin_max - bin_min``
    uniforms in ``[bin_min, bin_max]``.  ``rng`` defaults to the module-level
    ``random`` stream, exactly like the reference (seed via
    ``random.seed`` for reproducibility, or pass a ``random.Random``)."""
    uniform = (rng or random).uniform
    data: List[float] = []
    for i in range(k):
        bin_min = i * n // k
        bin_max = (i + 1) * n // k
        data.extend(uniform(bin_min, bin_max) for _ in range(bin_max - bin_min))
    return data


def iter_query_batches(
    data: List[float],
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: Optional[int] = None,
) -> Iterator[np.ndarray]:
    """Shuffled fp32 batches over ``data`` — the reference's
    ``create_dataloader``/``collate_fn`` contract (``datasets/
    utils.py:418-428``: ``shuffle=True``, ``torch.tensor(batch,
    dtype=torch.float32)``) as a framework-idiomatic numpy iterator.
    The tail batch is short, matching torch's default ``drop_last=False``."""
    order = np.arange(len(data))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    values = np.asarray(data, dtype=np.float32)
    for start in range(0, len(values), batch_size):
        yield values[order[start : start + batch_size]]
