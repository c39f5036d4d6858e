"""Evaluation: the alpha/beta hyperparameter sweep and accuracy metrics."""

from protoclip_tpu_torch.eval.gridsearch import (
    alpha_beta_sweep,
    best_cell,
    best_operating_point,
    default_alpha_beta_grid,
    sweep_to_triples,
    triples_to_sweep,
)
from protoclip_tpu_torch.eval.metrics import top_k_accuracy

__all__ = [
    "alpha_beta_sweep",
    "best_cell",
    "best_operating_point",
    "default_alpha_beta_grid",
    "sweep_to_triples",
    "triples_to_sweep",
    "top_k_accuracy",
]
