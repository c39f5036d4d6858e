"""Hyperparameter-sweep plots (ref ``utils.py:167-222``; a copy of
``protoclip_tpu/obs/plots.py``).  matplotlib is imported inside the plot,
which raises ``ImportError`` where it is absent."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def plot_alpha_beta_surface(
    acc_grid: np.ndarray,
    alphas: np.ndarray,
    betas: np.ndarray,
    out_path: str,
    title: str = "Proto-CLIP zero-shot",
    extra_grids: Optional[dict] = None,
) -> str:
    """3-D (alpha, beta) -> accuracy surface plot; returns the PNG path.

    ``extra_grids`` maps label -> another (A, B) accuracy grid (e.g. val +
    test curves like the reference's plot).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    A, B = np.meshgrid(alphas, betas, indexing="ij")
    ax.plot_surface(A, B, acc_grid, alpha=0.7, cmap="viridis")
    for label, grid in (extra_grids or {}).items():
        ax.plot_wireframe(A, B, grid, alpha=0.4, label=label)
    ax.set_xlabel("alpha")
    ax.set_ylabel("beta")
    ax.set_zlabel("accuracy")
    ax.set_title(title)
    if extra_grids:
        ax.legend()  # reference shows the split legend (utils.py:188)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    plt.savefig(out_path, dpi=200)
    plt.close(fig)
    return out_path


def report_best_operating_points(
    grids: dict, alphas: np.ndarray, betas: np.ndarray
) -> dict:
    """Best (alpha, beta, acc) per split + cross-split transfer accuracy
    (the reference prints val-selected test accuracy, ``utils.py:197-209``)."""
    from protoclip_tpu_torch.eval.gridsearch import best_operating_point

    out = {}
    for split, grid in grids.items():
        a, b, acc = best_operating_point(grid, alphas, betas)
        out[split] = {"alpha": a, "beta": b, "acc": acc}
    if "val" in grids and "test" in grids:
        ai = int(np.argmax(grids["val"]))
        out["test_at_val_best"] = float(grids["test"].ravel()[ai])
    return out
