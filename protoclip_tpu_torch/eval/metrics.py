"""Accuracy metrics (ref ``utils.py:247-253``; counterpart of
``protoclip_tpu/eval/metrics.py``).

Host numpy on purpose: these consume small, already-fetched score arrays."""

from __future__ import annotations

import numpy as np


def top_k_accuracy(scores, labels, k: int = 1) -> float:
    """Percentage of rows whose true label is within the top-k scores."""
    scores = _host(scores)
    labels = _host(labels)
    k = min(k, scores.shape[-1])
    # Stable sort (not argpartition) so ties at the k boundary break toward
    # the lower index, matching torch.topk on the reference path
    # (utils.py:247-253); the arrays are small, host-side O(n log n) is fine.
    top_idx = np.argsort(-scores, kind="stable", axis=-1)[:, :k]
    hit = (top_idx == labels[:, None]).any(axis=-1)
    return float(hit.mean() * 100.0)


def accuracy_from_probs(p, labels) -> float:
    """Fraction of rows whose argmax is the label."""
    return float(np.mean(np.argmax(_host(p), axis=-1) == _host(labels)))


def _host(x) -> np.ndarray:
    """A tensor on any device, or an array, as a host numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)
