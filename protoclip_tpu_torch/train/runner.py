"""The experiment runner, its test-only half (counterpart of
``protoclip_tpu/train/runner.py``; the reference's ``main()`` +
``run_proto_clip()``, ``main.py:105-552``):

1. load CLIP, build the dataset and its loaders;
2. build or load the visual and textual memory banks and the val/test
   features (cached in the reference's tree);
3. the zero-shot alpha/beta sweep (cached);
4. test a ``_v/_t/_a`` checkpoint at the config's (alpha, beta) and at
   re-searched ones.

Training (the episodic Proto-CLIP-F trainer, ``only_test=False``) is not
ported yet: :func:`run` raises for it.  The JAX runner's post-test t-SNE
plot of the prototypes is left out until the toolkit slice.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Callable, Dict, Optional

import numpy as np
import torch

from protoclip_tpu_torch.core.config import Config
from protoclip_tpu_torch.core.protoclip import accuracy, from_arrays
from protoclip_tpu_torch.data import BatchLoader, build_dataset, normalize_batch
from protoclip_tpu_torch.data.transforms import EvalTransform, TrainTransform
from protoclip_tpu_torch.device import DeviceLike, resolve_device
from protoclip_tpu_torch.eval.gridsearch import (
    alpha_beta_sweep,
    best_cell,
    best_operating_point,
    default_alpha_beta_grid,
    sweep_to_triples,
    triples_to_sweep,
)
from protoclip_tpu_torch.io.checkpoint import checkpoint_paths, load_checkpoint_triple
from protoclip_tpu_torch.memory import (
    FeatureCache,
    build_textual_memory_bank,
    build_visual_memory_bank,
    pre_load_features,
)
from protoclip_tpu_torch.models import adapter_from_torch_state, encode_image, encode_text, load_clip
from protoclip_tpu_torch.obs.logging import MetricLogger

TRAINING_SLICE = "ROADMAP.md queue 1 item 4 (the Proto-CLIP-F trainer)"


def make_encode_fns(cfg: Config, device: DeviceLike = None):
    """Load CLIP onto ``device`` (default: the card) and return
    ``(encode_images, encode_texts, clip_cfg, clip_params)``.

    ``encode_images(images_u8)`` takes a uint8 numpy batch, normalizes it on
    the device and returns the (B, d) features there; ``encode_texts``
    takes token ids.  Both run under ``torch.inference_mode``.
    """
    dev = resolve_device(device)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    clip_cfg, clip_params = load_clip(cfg.backbone, cfg.weights_path, dtype=dtype, device=dev)

    @torch.inference_mode()
    def encode_images(images_u8: np.ndarray) -> torch.Tensor:
        images = normalize_batch(torch.from_numpy(images_u8).to(dev), dtype)
        return encode_image(clip_params, images, clip_cfg)

    @torch.inference_mode()
    def encode_texts(tokens: np.ndarray) -> torch.Tensor:
        return encode_text(clip_params, torch.from_numpy(tokens).to(dev), clip_cfg)

    return encode_images, encode_texts, clip_cfg, clip_params


@dataclasses.dataclass
class ExperimentResult:
    zero_shot: Dict[str, float]
    test_acc_fixed: float
    test_acc_searched: float
    searched_alpha: float
    searched_beta: float
    best_val_acc: float
    best_epoch: int


@dataclasses.dataclass
class ExperimentSetup:
    """Everything the test phases need: encoders, dataset, banks, features,
    and the device the classifier runs on."""

    encode_fn: Callable
    text_fn: Callable
    clip_cfg: object
    clip_params: Dict
    cache: FeatureCache
    dataset: object
    bank_v: np.ndarray
    bank_values: np.ndarray
    bank_t: np.ndarray
    val_feats: np.ndarray
    val_labels: np.ndarray
    test_feats: np.ndarray
    test_labels: np.ndarray
    device: torch.device


def prepare_experiment(cfg: Config, progress: bool = True,
                       device: DeviceLike = None) -> ExperimentSetup:
    """Load CLIP, build the dataset and loaders, and materialize the memory
    banks and eval features (cached)."""
    dev = resolve_device(device)
    encode_fn, text_fn, clip_cfg, clip_params = make_encode_fns(cfg, dev)
    cache = FeatureCache(cfg.cache_dir, cfg.backbone, cfg.shots)
    dataset = build_dataset(cfg.dataset, cfg.root_path, cfg.shots, seed=cfg.seed)
    n_px = clip_cfg.image_resolution

    train_loader = BatchLoader(dataset.train_x, batch_size=cfg.batch_size,
                               transform=TrainTransform(n_px), shuffle=False, seed=cfg.seed,
                               image_size=n_px)
    val_loader = BatchLoader(dataset.val, batch_size=cfg.batch_size,
                             transform=EvalTransform(n_px), shuffle=False, image_size=n_px)
    test_loader = BatchLoader(dataset.test, batch_size=cfg.batch_size,
                              transform=EvalTransform(n_px), shuffle=False, image_size=n_px)

    bank_v, bank_values = build_visual_memory_bank(
        encode_fn, train_loader, cfg.augment_epoch, cache, progress=progress,
        expected_classes=dataset.num_classes,
    )
    bank_t = build_textual_memory_bank(text_fn, dataset.classnames, dataset.template, cache,
                                       context_length=clip_cfg.context_length)
    val_feats, val_labels = pre_load_features(encode_fn, val_loader, "val", cache, progress,
                                              expected_count=len(dataset.val))
    test_feats, test_labels = pre_load_features(encode_fn, test_loader, "test", cache, progress,
                                                expected_count=len(dataset.test))
    return ExperimentSetup(
        encode_fn=encode_fn, text_fn=text_fn, clip_cfg=clip_cfg, clip_params=clip_params,
        cache=cache, dataset=dataset, bank_v=bank_v, bank_values=bank_values, bank_t=bank_t,
        val_feats=val_feats, val_labels=val_labels, test_feats=test_feats,
        test_labels=test_labels, device=dev,
    )


def _cached_grid(cache: FeatureCache, stem: str, n_class: int, alphas, betas):
    """A cached sweep grid, or ``None`` where it must be recomputed.

    An ``.npz`` grid counts only with its ``n_class`` equal to this run's:
    the stems carry backbone and shots alone, and e.g. the 52- and
    198-class FewSOL variants share ``caches/fewsol``.  A reference pickle
    records no class count, so its rows must form exactly the default grid
    with accuracies in [0, 1]; a truncated, foreign or corrupt one is
    recomputed, not adopted."""
    cached = cache.load(stem)
    if cached is None:
        return None
    if "acc" in cached:
        if "n_class" not in cached or int(cached["n_class"]) != n_class:
            return None
        return cached["acc"]
    if "triples" not in cached and "array" not in cached:
        return None
    try:
        grid = triples_to_sweep(cached.get("triples", cached.get("array")), alphas, betas)
        if not (np.isfinite(grid).all() and float(grid.min()) >= 0.0
                and float(grid.max()) <= 1.0):
            raise ValueError("accuracies outside [0, 1]")
    except ValueError as exc:
        print(f"[protoclip_tpu_torch] cached HP grid {stem} is invalid ({exc}); recomputing",
              file=sys.stderr)
        return None
    return grid


def zero_shot_sweep_phase(cfg: Config, setup: ExperimentSetup, logger: MetricLogger,
                          progress: bool) -> Dict[str, float]:
    """The zero-shot alpha/beta sweep over val, test and train, cached in
    the reference's pickle-compatible stems, with the surface plot and the
    best-HP report (ref ``main.py:167-211``)."""
    cache, bank_t = setup.cache, setup.bank_t
    alphas, betas = default_alpha_beta_grid()
    img_protos = from_arrays(setup.bank_v, bank_t, {}, "fc", cfg.shots,
                             device=setup.device).prototypes()[0]
    text_protos = bank_t / np.linalg.norm(bank_t, axis=-1, keepdims=True)
    n_class = int(bank_t.shape[0])
    zs: Dict[str, float] = {}
    grids: Dict[str, np.ndarray] = {}
    for split, feats, labels in (
        ("val", setup.val_feats, setup.val_labels),
        ("test", setup.test_feats, setup.test_labels),
        ("train", setup.bank_v, np.argmax(setup.bank_values, axis=1)),
    ):
        stem = cache.hp_search_stem(split)
        acc_grid = _cached_grid(cache, stem, n_class, alphas, betas)
        if acc_grid is None:
            acc_grid = alpha_beta_sweep(feats, labels, img_protos, text_protos, alphas, betas)
            cache.save(stem, acc=acc_grid, triples=sweep_to_triples(acc_grid, alphas, betas),
                       n_class=np.int64(n_class))
        grids[split] = np.asarray(acc_grid)
        a, b, best = best_operating_point(acc_grid, alphas, betas)
        zs[f"{split}_best_alpha"], zs[f"{split}_best_beta"], zs[f"{split}_best_acc"] = a, b, best
        logger.scalar(f"zero_shot/{split}_best_acc", best, 0)
    _log_sweep_report(grids, alphas, betas, cfg, logger, step=0, phase="zero_shot")
    if progress:
        print(f"[zero-shot] val best {zs['val_best_acc']*100:.2f}% "
              f"(a={zs['val_best_alpha']}, b={zs['val_best_beta']}) | "
              f"test best {zs['test_best_acc']*100:.2f}%")
    return zs


def _log_sweep_report(grids: Dict[str, np.ndarray], alphas: np.ndarray, betas: np.ndarray,
                      cfg: Config, logger: MetricLogger, step: int, phase: str) -> None:
    """Surface plot + best-HP report of a sweep (ref ``utils.py:167-222``).
    Without matplotlib the plot is skipped; the scalars are logged."""
    from protoclip_tpu_torch.obs.plots import plot_alpha_beta_surface, report_best_operating_points

    report = report_best_operating_points(grids, alphas, betas)
    plot_path = os.path.join(logger.log_dir, f"alpha_beta_{phase}_{cfg.dataset}.png")
    try:
        plot_alpha_beta_surface(
            grids["val"], alphas, betas, plot_path,
            title=f"Proto-CLIP | Dataset:{cfg.dataset} ({phase})",
            extra_grids={s: g for s, g in grids.items() if s != "val"},
        )
        logger.image(f"alpha-beta/{phase}", plot_path, step)
    except ImportError:
        pass
    if "val" in report:
        logger.scalar("HP/alpha-val-test", report["val"]["alpha"], step + 1)
        logger.scalar("HP/beta-val-test", report["val"]["beta"], step + 1)
    if "test" in report:
        logger.scalar("HP/alpha-val-test", report["test"]["alpha"], step + 2)
        logger.scalar("HP/beta-val-test", report["test"]["beta"], step + 2)
    if "test_at_val_best" in report:
        logger.scalar("Accuracy/zsval-zstestval-zstest-3F-test", report["test_at_val_best"],
                      step + 2)


def evaluate_checkpoint(cfg: Config, setup: ExperimentSetup, ckpt_paths_vta, alpha: float,
                        beta: float, logger: MetricLogger, progress: bool) -> ExperimentResult:
    """The test phase (ref ``main.py:383-458``): load the ``_v/_t/_a``
    triple, score it at (alpha, beta), then re-search alpha/beta on the
    adapted features.  As in the reference (``main.py:407-415``), the
    searched sweep's val features are not re-normalized after the adapter,
    the test and train features are."""
    bank_v, bank_t, adapter_state = load_checkpoint_triple(*ckpt_paths_vta)
    model = from_arrays(bank_v, bank_t, adapter_from_torch_state(adapter_state, cfg.adapter),
                        cfg.adapter, cfg.shots, device=setup.device)
    test_acc_fixed = accuracy(model, setup.test_feats, setup.test_labels, alpha, beta)
    logger.scalar("Accuracy/test_fixed", test_acc_fixed, 0)

    alphas, betas = default_alpha_beta_grid()
    with torch.inference_mode():
        img_p, txt_p = model.prototypes()
        val_adapted = model.adapt(setup.val_feats, normalize=False)
        test_adapted = model.adapt(setup.test_feats, normalize=True)
        train_adapted = model.adapt(setup.bank_v, normalize=True)
    train_labels = np.argmax(setup.bank_values, axis=1)
    val_grid = alpha_beta_sweep(val_adapted, setup.val_labels, img_p, txt_p, alphas, betas)
    test_grid = alpha_beta_sweep(test_adapted, setup.test_labels, img_p, txt_p, alphas, betas)
    train_grid = alpha_beta_sweep(train_adapted, train_labels, img_p, txt_p, alphas, betas)
    ai, bi = best_cell(val_grid)
    a_s, b_s = float(alphas[ai]), float(betas[bi])
    test_acc_searched = float(test_grid[ai, bi])
    logger.scalar("Accuracy/test_searched", test_acc_searched, 0)
    _log_sweep_report({"val": val_grid, "test": test_grid, "train": train_grid},
                      alphas, betas, cfg, logger, step=10, phase="test")
    if progress:
        print(f"[test] fixed(a={alpha}, b={beta}): {test_acc_fixed*100:.2f}% | "
              f"searched(a={a_s}, b={b_s}): {test_acc_searched*100:.2f}%")
    return ExperimentResult(
        zero_shot={}, test_acc_fixed=test_acc_fixed, test_acc_searched=test_acc_searched,
        searched_alpha=a_s, searched_beta=b_s, best_val_acc=0.0, best_epoch=-1,
    )


def run(cfg: Config, progress: bool = True, logger: Optional[MetricLogger] = None,
        device: DeviceLike = None) -> ExperimentResult:
    """Run one Proto-CLIP experiment from a config, on ``device`` (default:
    the card).  Only ``cfg.only_test`` runs are ported: the checkpoint
    triple at the config's operating point is tested against the cached
    (or freshly built) banks and features."""
    cfg.validate()
    if not cfg.only_test:
        raise NotImplementedError(
            f"training is not ported yet; it comes with {TRAINING_SLICE}. "
            "Run with only_test=True (--only_test) against an existing checkpoint triple."
        )
    own_logger = logger is None
    logger = logger or MetricLogger(os.path.join(cfg.logs_dir_path, cfg.dataset))
    try:
        setup = prepare_experiment(cfg, progress, device)
        zs = zero_shot_sweep_phase(cfg, setup, logger, progress)
        # the reference overrides the searched HPs with the config's
        # (main.py:213-214): the checkpoint is tested at the tuned point
        alpha, beta = cfg.alpha, cfg.beta
        paths = checkpoint_paths(cfg.cache_dir, cfg.backbone, cfg.shots, alpha, beta,
                                 cfg.lr, cfg.augment_epoch, cfg.train_epoch)
        result = evaluate_checkpoint(cfg, setup, paths, alpha, beta, logger, progress)
    finally:
        if own_logger:
            logger.close()
        else:
            logger.flush()
    return dataclasses.replace(result, zero_shot=zs)
