"""The experiment runner (counterpart of ``protoclip_tpu/train/runner.py``;
the reference's ``main()`` + ``run_proto_clip()``, ``main.py:105-552``):

1. load CLIP, build the dataset and its loaders;
2. build or load the visual and textual memory banks and the val/test
   features (cached in the reference's tree);
3. the zero-shot alpha/beta sweep (cached);
4. unless ``only_test``, train (the episodic Proto-CLIP-F trainer here, the
   F-Q^T trainer in ``train/qt_runner.py``), saving the ``_v/_t/_a``
   triple at each best val accuracy and, every ``snapshot_every`` epochs,
   the trainer's state for ``resume``;
5. test the triple at the config's (alpha, beta) and at re-searched ones,
   and plot the trained prototypes' t-SNE where sklearn and matplotlib
   import.
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
from protoclip_tpu_torch.io.checkpoint import (
    checkpoint_paths,
    load_checkpoint_triple,
    save_checkpoint_triple,
)
from protoclip_tpu_torch.memory import (
    FeatureCache,
    build_textual_memory_bank,
    build_visual_memory_bank,
    pre_load_features,
)
from protoclip_tpu_torch.models import (
    adapter_from_torch_state,
    adapter_to_torch_state,
    encode_image,
    encode_text,
    load_clip,
)
from protoclip_tpu_torch.obs.logging import MetricLogger
from protoclip_tpu_torch.obs.profiler import span
from protoclip_tpu_torch.parallel import (
    make_sharded_encode,
    mesh_batch,
    process_device,
    replicated,
    shard_batch,
)
from protoclip_tpu_torch.train.episodic import EpisodicTrainer


def make_encode_fns(cfg: Config, device: DeviceLike = None, mesh=None,
                    int8: Optional[bool] = None):
    """Load CLIP onto ``device`` (default: the card) and return
    ``(encode_images, encode_texts, clip_cfg, clip_params)``.

    ``encode_images(images_u8)`` takes a uint8 numpy batch, normalizes it on
    the device and returns the (B, d) features there; ``encode_texts``
    takes token ids.  Both run under ``torch.inference_mode``.  With a
    ``mesh`` (``parallel.make_mesh``) the weights are loaded onto its first
    device and copied once to the others, and image batches shard over the
    mesh with the features gathered back onto the first device: a batch
    whose rows do not divide over the mesh is zero-padded to the next
    multiple of ``mesh.size`` first, and its features come back at the
    batch's own rows.  The text encode stays on the first device, as JAX's
    stays unsharded.  ``int8`` picks the towers' block mode (True: the W8A8
    serving block, K3; None reads ``$PROTOCLIP_INT8``).  The copy of an
    image batch to the device is the ``encode.upload`` span (rows and
    bytes: the uint8 rows uploaded, padding included).
    """
    dev = process_device(device, mesh)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    clip_cfg, clip_params = load_clip(cfg.backbone, cfg.weights_path, dtype=dtype, device=dev,
                                      int8=int8)

    def image(params, images_u8: torch.Tensor) -> torch.Tensor:
        return encode_image(params, normalize_batch(images_u8, dtype), clip_cfg, int8=int8)

    if mesh is None:
        weights = clip_params

        def run(params, images_u8: np.ndarray) -> torch.Tensor:
            with span("encode.upload", rows=len(images_u8), nbytes=images_u8.nbytes):
                images = torch.from_numpy(images_u8).to(dev)
            return image(params, images)
    else:
        weights = replicated(mesh).put(clip_params)
        sharded = make_sharded_encode(image, mesh)

        def run(params, images_u8: np.ndarray) -> torch.Tensor:
            rows = len(images_u8)
            short = -rows % mesh.size
            if short:
                images_u8 = np.concatenate(
                    [images_u8, np.zeros((short, *images_u8.shape[1:]), images_u8.dtype)])
            with span("encode.upload", rows=len(images_u8), nbytes=images_u8.nbytes):
                batch = shard_batch(images_u8, mesh)
            return sharded(params, batch)[:rows]

    @torch.inference_mode()
    def encode_images(images_u8: np.ndarray) -> torch.Tensor:
        return run(weights, images_u8)

    @torch.inference_mode()
    def encode_texts(tokens: np.ndarray) -> torch.Tensor:
        return encode_text(clip_params, torch.from_numpy(tokens).to(dev), clip_cfg, int8=int8)

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


def prepare_experiment(cfg: Config, progress: bool = True, device: DeviceLike = None,
                       mesh=None, int8: Optional[bool] = None) -> ExperimentSetup:
    """Load CLIP, build the dataset and loaders, and materialize the memory
    banks and eval features (cached).  With a ``mesh`` the image encodes
    shard over it (:func:`make_encode_fns`) and everything else runs on its
    first device; ``int8`` as in :func:`make_encode_fns`."""
    dev = process_device(device, mesh)
    encode_fn, text_fn, clip_cfg, clip_params = make_encode_fns(cfg, dev, mesh, int8)
    cache = FeatureCache(cfg.cache_dir, cfg.backbone, cfg.shots)
    dataset = build_dataset(cfg.dataset, cfg.root_path, cfg.shots, seed=cfg.seed)
    n_px = clip_cfg.image_resolution
    batch_size = mesh_batch(cfg.batch_size, mesh)

    train_loader = BatchLoader(dataset.train_x, batch_size=batch_size,
                               transform=TrainTransform(n_px), shuffle=False, seed=cfg.seed,
                               image_size=n_px)
    val_loader = BatchLoader(dataset.val, batch_size=batch_size,
                             transform=EvalTransform(n_px), shuffle=False, image_size=n_px)
    test_loader = BatchLoader(dataset.test, batch_size=batch_size,
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

    # post-test prototype t-SNE to TensorBoard (ref main.py:457-458,
    # utils.py:125-164); a host plot, skipped where its libraries are absent
    try:
        from protoclip_tpu_torch.toolkit.tsne import plot_prototype_tsne

        plot_prototype_tsne(
            img_p.cpu().numpy(), txt_p.cpu().numpy(), setup.dataset.classnames,
            os.path.join(logger.log_dir, f"tsne_prototypes_{cfg.dataset}.png"),
            logger=logger, tag="t-SNE/prototypes",
        )
    except ImportError:
        pass
    if progress:
        print(f"[test] fixed(a={alpha}, b={beta}): {test_acc_fixed*100:.2f}% | "
              f"searched(a={a_s}, b={b_s}): {test_acc_searched*100:.2f}%")
    return ExperimentResult(
        zero_shot={}, test_acc_fixed=test_acc_fixed, test_acc_searched=test_acc_searched,
        searched_alpha=a_s, searched_beta=b_s, best_val_acc=0.0, best_epoch=-1,
    )


# per-term TensorBoard tags of the reference (main.py:287-302,
# main.qt.py:227-243), shared by both training loops
TERM_TAGS = {
    "L1": "Loss/train/L1-negLog",
    "L2": "Loss/train/L2-img2txt_align",
    "L3": "Loss/train/L3-txt2img_align",
    "L4": "Loss/train/L4-img_inter_cluster",
    "L5": "Loss/train/L5-txt_inter_cluster",
}


def log_epoch_scalars(logger: MetricLogger, epoch: int, *, train_loss: float, val_loss: float,
                      train_acc: float, val_acc: float, lr: float,
                      term_values: Dict[str, float]) -> None:
    """One epoch's scalar block (both runners; ref ``main.py:372-378``)."""
    logger.scalar("Loss/train", train_loss, epoch)
    logger.scalar("Loss/val", val_loss, epoch)
    logger.scalar("Accuracy/train", train_acc, epoch)
    logger.scalar("Accuracy/val", val_acc, epoch)
    logger.scalar("HP/lr", lr, epoch)
    for term, tag in TERM_TAGS.items():
        if term in term_values:
            logger.scalar(tag, term_values[term], epoch)


def save_model_checkpoint(model, adapter_kind: str, paths) -> None:
    """Write a model's ``_v/_t/_a`` triple (the best-val save of both
    runners, ref ``main.py:350-369``)."""
    save_checkpoint_triple(*paths, model.bank_v, model.bank_t,
                           adapter_to_torch_state(model.adapter, adapter_kind))


def snapshot_path(ckpt_v: str) -> str:
    """The trainer-state snapshot beside the triple, under the triple's own
    lr/aug/epochs prefix: the alpha-beta directory is shared by every
    (lr, augment_epoch, train_epoch) operating point, so a bare name there
    would let another operating point resume from this one's state."""
    stem = os.path.basename(ckpt_v)
    suffix = "_v.pt"
    stem = stem[: -len(suffix)] if stem.endswith(suffix) else os.path.splitext(stem)[0]
    return os.path.join(os.path.dirname(ckpt_v), f"{stem}_train_state.pkl")


def maybe_resume(cfg: Config, trainer, snap_path: str, best_val: float, best_epoch: int,
                 progress: bool):
    """With ``cfg.resume`` and a snapshot at ``snap_path``: restore the
    trainer and the best-val bookkeeping (so a post-resume epoch never
    replaces a better checkpoint).  Returns (start epoch, best val, best
    epoch)."""
    if not cfg.resume or not os.path.exists(snap_path):
        return 0, best_val, best_epoch
    from protoclip_tpu_torch.train.resume import load_train_state

    start_epoch, extra = load_train_state(snap_path, trainer)
    best_val = float(extra.get("best_val", best_val))
    best_epoch = int(extra.get("best_epoch", best_epoch))
    if progress:
        print(f"[resume] restored {snap_path} at epoch {start_epoch} "
              f"(best val {best_val*100:.2f}% @ {best_epoch})")
    return start_epoch, best_val, best_epoch


def maybe_snapshot(cfg: Config, trainer, snap_path: str, epoch: int, best_val: float,
                   best_epoch: int) -> None:
    """The preemption snapshot, every ``cfg.snapshot_every`` epochs."""
    if cfg.snapshot_every and (epoch + 1) % cfg.snapshot_every == 0:
        from protoclip_tpu_torch.train.resume import save_train_state

        save_train_state(snap_path, trainer, extra={"best_val": best_val, "best_epoch": best_epoch})


def make_val_metrics_fn(val_feats, val_labels, alpha: float, beta: float,
                        device: DeviceLike = None) -> Callable:
    """``model -> (val accuracy, val loss)`` at a fixed (alpha, beta), the
    features moved to ``device`` once.  The val loss is the reference's: the
    NLL of the *predicted* class (``main.py:341-344``), not of the true one."""
    dev = resolve_device(device)
    feats = torch.as_tensor(np.asarray(val_feats, np.float32)).to(dev)
    labels = torch.as_tensor(np.asarray(val_labels)).to(dev).long()

    @torch.inference_mode()
    def val_metrics(model):
        p = model.probs(feats, alpha, beta)
        acc = (p.argmax(dim=-1) == labels).float().mean()
        loss = -torch.log(p.max(dim=-1).values + 1e-12).mean()
        return float(acc), float(loss)

    return val_metrics


def fit(cfg: Config, trainer, setup: ExperimentSetup, paths, logger: MetricLogger,
        progress: bool, desc: str, run_epoch: Callable[[int], Dict[str, float]]):
    """The training loop both runners share (ref ``main.py:216-381``):
    resume if asked, then per epoch ``run_epoch(epoch)`` (its stats: loss,
    acc, lr and the loss terms), the val metrics of ``trainer.model()``, the
    epoch's scalars, the triple at each val accuracy >= the best so far, and
    the periodic snapshot.  Returns (best val accuracy, its epoch)."""
    val_metrics = make_val_metrics_fn(setup.val_feats, setup.val_labels, cfg.alpha, cfg.beta,
                                      setup.device)
    snap_path = snapshot_path(paths[0])
    start_epoch, best_val, best_epoch = maybe_resume(cfg, trainer, snap_path, 0.0, -1, progress)
    epochs = range(start_epoch, cfg.train_epoch)
    if progress:
        from tqdm import tqdm

        epochs = tqdm(epochs, desc=desc, initial=start_epoch, total=cfg.train_epoch)
    for epoch in epochs:
        stats = run_epoch(epoch)
        model = trainer.model()
        va, vl = val_metrics(model)
        log_epoch_scalars(logger, epoch, train_loss=stats["loss"], val_loss=vl,
                          train_acc=stats["acc"], val_acc=va, lr=stats["lr"],
                          term_values={t: stats[t] for t in TERM_TAGS if t in stats})
        if va >= best_val:
            best_val, best_epoch = va, epoch
            save_model_checkpoint(model, cfg.adapter, paths)
        maybe_snapshot(cfg, trainer, snap_path, epoch, best_val, best_epoch)
    if progress:
        print(f"Best val acc {best_val*100:.2f}% @ epoch {best_epoch}")
    return best_val, best_epoch


def run(cfg: Config, progress: bool = True, logger: Optional[MetricLogger] = None,
        device: DeviceLike = None, mesh=None, int8: Optional[bool] = None) -> ExperimentResult:
    """Run one Proto-CLIP experiment from a config, on ``device`` (default:
    the card): prepare, the zero-shot sweep, the episodic Proto-CLIP-F
    trainer (unless ``cfg.only_test``) and the test of the best triple at
    the config's operating point.

    With a ``mesh`` the encodes (bank build, val/test features) shard their
    batches over it.  Episodic training runs on the mesh's first device on
    purpose, as in the JAX package: an episode is one AdamW step over at most
    a few thousand d-dim rows (adapter and bank gathers, no CLIP forward),
    far too little work to share.  The F-Q^T trainer
    (``train/qt_runner.py``), whose step crosses the image tower, shards
    its batches.  ``int8`` picks the encodes' block mode (True: the W8A8
    serving block; None reads ``$PROTOCLIP_INT8``); give the W8A8 mode a
    cache tree of its own, as its features differ."""
    cfg.validate()
    own_logger = logger is None
    logger = logger or MetricLogger(os.path.join(cfg.logs_dir_path, cfg.dataset))
    try:
        setup = prepare_experiment(cfg, progress, device, mesh, int8)
        zs = zero_shot_sweep_phase(cfg, setup, logger, progress)
        # the reference overrides the searched HPs with the config's
        # (main.py:213-214): training and the test run at the tuned point
        alpha, beta = cfg.alpha, cfg.beta
        paths = checkpoint_paths(cfg.cache_dir, cfg.backbone, cfg.shots, alpha, beta,
                                 cfg.lr, cfg.augment_epoch, cfg.train_epoch)
        best_val, best_epoch = 0.0, -1
        if not cfg.only_test:
            if mesh is not None and progress:
                print("[mesh] episodic training runs on one device by design (episodes are "
                      "tiny adapter/bank steps); the encode phases were sharded over the mesh")
            trainer = EpisodicTrainer(
                frozen_keys=setup.bank_v, bank_t_init=setup.bank_t,
                n_class=setup.dataset.num_classes, k_shots=cfg.shots, adapter_kind=cfg.adapter,
                alpha=alpha, beta=beta, lr=cfg.lr, train_epoch=cfg.train_epoch,
                losses=tuple(cfg.losses), train_vis_mem_only=cfg.train_vis_mem_only,
                seed=cfg.seed, device=setup.device,
            )
            best_val, best_epoch = fit(cfg, trainer, setup, paths, logger, progress,
                                       f"train {cfg.dataset}", lambda epoch: trainer.run_epoch())
        result = evaluate_checkpoint(cfg, setup, paths, alpha, beta, logger, progress)
    finally:
        if own_logger:
            logger.close()
        else:
            logger.flush()
    return dataclasses.replace(result, zero_shot=zs, best_val_acc=best_val,
                               best_epoch=best_epoch)
