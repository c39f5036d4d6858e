"""The experiment runner (its test-only half; the trainers come with a
later slice)."""

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
    "ExperimentResult",
    "ExperimentSetup",
    "evaluate_checkpoint",
    "make_encode_fns",
    "prepare_experiment",
    "run",
    "zero_shot_sweep_phase",
]
