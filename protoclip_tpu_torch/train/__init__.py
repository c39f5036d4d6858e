"""Trainers and the experiment runner: Proto-CLIP-F (episodic over cached
features, ``main.py:216-381``) and Proto-CLIP-F-Q^T (live CLIP-encoded
queries, ``main.qt.py:184-260``), with AdamW, the cosine schedule and
replay-exact snapshots."""

from protoclip_tpu_torch.train.episodic import (
    EpisodicTrainer,
    make_episode_masks,
    make_episode_queries,
)
from protoclip_tpu_torch.train.optim import cosine_lr, make_optimizer
from protoclip_tpu_torch.train.qt import QTTrainer
from protoclip_tpu_torch.train.runner import (
    ExperimentResult,
    ExperimentSetup,
    evaluate_checkpoint,
    make_encode_fns,
    prepare_experiment,
    run,
    zero_shot_sweep_phase,
)

__all__ = [
    "EpisodicTrainer",
    "ExperimentResult",
    "ExperimentSetup",
    "QTTrainer",
    "cosine_lr",
    "evaluate_checkpoint",
    "make_encode_fns",
    "make_episode_masks",
    "make_episode_queries",
    "make_optimizer",
    "prepare_experiment",
    "run",
    "zero_shot_sweep_phase",
]
