"""The alpha/beta hyperparameter sweep (counterpart of
``protoclip_tpu/eval/gridsearch.py``).

The reference evaluates an 11 x 29 (alpha, beta) grid with a Python double
loop calling ``P`` per cell.  Here the two logit matrices are computed once
on the device, every beta runs one softmax pair vectorized over all alphas,
and only the (A, B) accuracy grid leaves the device, in one transfer.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from protoclip_tpu_torch.ops.proto import proto_logits


def default_alpha_beta_grid() -> Tuple[np.ndarray, np.ndarray]:
    """The reference grid (``main.py:142-146``): alpha 0..1 step .1,
    beta {0.1..0.9} U {1..20}."""
    alphas = np.round(np.arange(0, 1.1, 0.1), 1)
    betas = np.concatenate([np.arange(0.1, 1.0, 0.1), np.arange(1.0, 21.0, 1.0)])
    return alphas.astype(np.float32), betas.astype(np.float32)


def _on(x, device: torch.device, dtype=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), device=device, dtype=dtype)


@torch.inference_mode()
def alpha_beta_sweep(features, labels, img_protos, text_protos,
                     alphas: Optional[np.ndarray] = None,
                     betas: Optional[np.ndarray] = None) -> np.ndarray:
    """Accuracy for every (alpha, beta) cell -> fp32 array (A, B).

    Runs on the device of ``img_protos``; ``features`` are cached
    (optionally adapter-transformed) query features.
    """
    d_alphas, d_betas = default_alpha_beta_grid()
    alphas = d_alphas if alphas is None else alphas
    betas = d_betas if betas is None else betas
    dev = img_protos.device if isinstance(img_protos, torch.Tensor) else torch.device("cpu")
    feats = _on(features, dev, torch.float32)
    labels = _on(labels, dev).long()
    logits_img = proto_logits(feats, _on(img_protos, dev))  # (Q, N), fp32
    logits_text = proto_logits(feats, _on(text_protos, dev))
    a = _on(alphas, dev, torch.float32)[:, None, None]  # (A, 1, 1)
    rows = []
    for beta in np.asarray(betas, np.float32).tolist():
        p_img = torch.softmax(beta * logits_img, dim=-1)
        p_text = torch.softmax(beta * logits_text, dim=-1)
        preds = (a * p_img + (1.0 - a) * p_text).argmax(dim=-1)  # (A, Q)
        rows.append((preds == labels).float().mean(dim=-1))
    return torch.stack(rows, dim=1).cpu().numpy()  # (A, B)


def sweep_to_triples(acc: np.ndarray, alphas: np.ndarray, betas: np.ndarray) -> np.ndarray:
    """Flatten to the reference's ``[alpha, beta, acc]`` row list
    (alpha-major order, ``main.py:187-199``)."""
    rows = [
        [float(a), float(b), float(acc[i, j])]
        for i, a in enumerate(alphas)
        for j, b in enumerate(betas)
    ]
    return np.asarray(rows, dtype=np.float32)


def triples_to_sweep(triples: np.ndarray, alphas: np.ndarray, betas: np.ndarray) -> np.ndarray:
    """Inverse of :func:`sweep_to_triples`: rebuild the ``(A, B)`` grid
    from an ``[alpha, beta, acc]`` row list, matching rows by value."""
    triples = np.asarray(triples, np.float32)
    if triples.ndim != 2 or triples.shape[1] != 3:
        raise ValueError(f"expected (M, 3) [alpha, beta, acc] rows, got {triples.shape}")
    acc = np.full((len(alphas), len(betas)), np.nan, np.float32)
    ai = {round(float(a), 4): i for i, a in enumerate(alphas)}
    bj = {round(float(b), 4): j for j, b in enumerate(betas)}
    for a, b, v in triples:
        i, j = ai.get(round(float(a), 4)), bj.get(round(float(b), 4))
        if i is not None and j is not None:
            acc[i, j] = v
    if np.isnan(acc).any():
        raise ValueError("cached HP grid does not cover the full alpha/beta grid")
    return acc


def best_cell(acc: np.ndarray) -> Tuple[int, int]:
    """Grid indices of the best cell; ties resolve to the earliest cell in
    alpha-major order, matching ``argmax`` over the reference's row list."""
    i, j = np.unravel_index(int(np.argmax(acc)), acc.shape)
    return int(i), int(j)


def best_operating_point(acc: np.ndarray, alphas: np.ndarray, betas: np.ndarray
                         ) -> Tuple[float, float, float]:
    """(best_alpha, best_beta, best_acc) of the grid (see :func:`best_cell`)."""
    i, j = best_cell(acc)
    return float(alphas[i]), float(betas[j]), float(acc[i, j])
