"""The numbers that decide ``correct``: what the timed path produced,
against the plain reference's answers to the same inputs."""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np


def feature_err(got: np.ndarray, ref: np.ndarray) -> float:
    """The worst row's relative error ``|got - ref| / |ref|``."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        raise ValueError(f"answers of shape {got.shape} against the reference's {ref.shape}")
    err = np.linalg.norm(got - ref, axis=-1) / np.linalg.norm(ref, axis=-1)
    return float(err.max()) if err.size else 0.0


def topk_errs(answers: Iterable[Tuple[np.ndarray, np.ndarray, np.ndarray]],
              ref_p: np.ndarray) -> dict:
    """Served top-k answers ``(input rows, class ids (n, k), probabilities
    (n, k))`` against the reference's probabilities ``ref_p`` (inputs, N):

    - ``prob_err``: the worst relative gap between a served probability and
      the reference's probability of the same class;
    - ``rank_gap``: the worst log-ratio by which the reference's
      probability of a served class lies below the reference's own
      probability at that rank (0 where the served class is as likely).
    """
    ref_sorted = -np.sort(-ref_p, axis=-1)
    prob_err = rank_gap = 0.0
    for rows, ids, probs in answers:
        want = ref_p[rows[:, None], ids]
        prob_err = max(prob_err, float((np.abs(probs - want) / want).max()))
        ranked = ref_sorted[rows, :ids.shape[1]]
        rank_gap = max(rank_gap, float(np.log(ranked / want).max()))
    return {"prob_err": prob_err, "rank_gap": rank_gap}
