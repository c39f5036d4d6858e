"""The F-Q^T experiment runner (counterpart of
``protoclip_tpu/train/qt_runner.py``; the ``main.qt.py`` flow,
``main.qt.py:418-500``): the episodic runner's setup and zero-shot sweep,
then training on a *shuffled*, augmented few-shot loader whose batches the
frozen image tower encodes anew at every step.  The reference's interactive
``input()`` gate is dropped."""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np

from protoclip_tpu_torch.core.config import Config
from protoclip_tpu_torch.data import BatchLoader
from protoclip_tpu_torch.data.transforms import TrainTransform
from protoclip_tpu_torch.device import DeviceLike
from protoclip_tpu_torch.io.checkpoint import checkpoint_paths
from protoclip_tpu_torch.obs.logging import MetricLogger
from protoclip_tpu_torch.parallel import mesh_batch
from protoclip_tpu_torch.train.qt import QTTrainer
from protoclip_tpu_torch.train.runner import (
    TERM_TAGS,
    ExperimentResult,
    evaluate_checkpoint,
    fit,
    prepare_experiment,
    zero_shot_sweep_phase,
)


def run_qt(cfg: Config, progress: bool = True, logger: Optional[MetricLogger] = None,
           device: DeviceLike = None, mesh=None) -> ExperimentResult:
    """Run one Proto-CLIP-F-Q^T experiment on ``device`` (default: the
    card); the best triple goes under ``best-alpha-beta/``.  With a
    ``mesh`` the encodes and every step's frozen encode shard over it
    (``train/qt.py``)."""
    cfg.validate()
    own_logger = logger is None
    logger = logger or MetricLogger(os.path.join(cfg.logs_dir_path, f"{cfg.dataset}-qt"))
    try:
        setup = prepare_experiment(cfg, progress, device, mesh)
        # the reference's Q^T flow runs the same zero-shot phase before
        # training (main.qt.py:109-183)
        zs = zero_shot_sweep_phase(cfg, setup, logger, progress)
        alpha, beta = cfg.alpha, cfg.beta
        paths = checkpoint_paths(cfg.cache_dir, cfg.backbone, cfg.shots, alpha, beta,
                                 cfg.lr, cfg.augment_epoch, cfg.train_epoch, qt=True)
        best_val, best_epoch = 0.0, -1
        if not cfg.only_test:
            n_px = setup.clip_cfg.image_resolution
            # shuffled and augmented, re-encoded at every step (ref
            # main.qt.py:456-468); the batch is clamped to the train set,
            # then rounded up to a multiple of the mesh
            batch_size = mesh_batch(min(cfg.batch_size, len(setup.dataset.train_x)), mesh)
            loader = BatchLoader(setup.dataset.train_x, batch_size=batch_size,
                                 transform=TrainTransform(n_px), shuffle=True, seed=cfg.seed,
                                 image_size=n_px)
            trainer = QTTrainer(
                clip_params=setup.clip_params, clip_cfg=setup.clip_cfg,
                bank_v_init=setup.bank_v, bank_t_init=setup.bank_t,
                n_class=setup.dataset.num_classes, k_shots=cfg.shots, adapter_kind=cfg.adapter,
                alpha=alpha, beta=beta, lr=cfg.lr, train_epoch=cfg.train_epoch,
                losses=tuple(cfg.losses), train_vis_mem_only=cfg.train_vis_mem_only,
                seed=cfg.seed, compute_dtype=cfg.compute_dtype, device=setup.device,
                mesh=mesh,
            )

            def run_epoch(epoch: int) -> Dict[str, float]:
                # the loader's order and draws are functions of (seed,
                # epoch): a resumed run replays the uninterrupted batches
                loader.set_epoch(epoch)
                losses, correct, seen = [], 0.0, 0
                term_sums: Dict[str, list] = {}
                for images, labels, n_valid in loader:
                    stats = trainer.train_step(images, labels, n_valid)
                    losses.append(stats["loss"])
                    # the epoch's accuracy is correct / all, as the
                    # reference's, not a mean over ragged batches
                    correct += stats["acc"] * n_valid
                    seen += n_valid
                    for term in TERM_TAGS:
                        if term in stats:
                            term_sums.setdefault(term, []).append(stats[term])
                trainer.finish_epoch()
                return {"loss": float(np.mean(losses)), "acc": correct / max(seen, 1),
                        "lr": stats["lr"],
                        **{t: float(np.mean(v)) for t, v in term_sums.items()}}

            best_val, best_epoch = fit(cfg, trainer, setup, paths, logger, progress,
                                       f"train-qt {cfg.dataset}", run_epoch)
        result = evaluate_checkpoint(cfg, setup, paths, alpha, beta, logger, progress)
    finally:
        if own_logger:
            logger.close()
        else:
            logger.flush()
    return dataclasses.replace(result, zero_shot=zs, best_val_acc=best_val,
                               best_epoch=best_epoch)
