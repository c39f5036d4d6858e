"""Visual / textual memory-bank construction (counterpart of
``protoclip_tpu/memory/banks.py``).

Reference behavior being matched:

- Visual bank (``utils.py:284-332``): ``augment_epoch`` passes over the
  *unshuffled* few-shot train loader with random-crop/flip transforms;
  features are averaged over passes in fp32, L2-normalized, sorted by label;
  labels become one-hot values.  Bank layout here is row-major ``(N*K, d)``
  (the reference keeps the transpose ``(d, N*K)``; row-major matches how the
  trainer consumes it and the ``_v.pt`` checkpoint layout).
- Textual bank (``utils.py:256-273``): for every class, fill every template,
  tokenize, encode, L2-normalize each prompt embedding, average over the
  ensemble, re-normalize -> ``(N, d)``.  All ``N * T`` prompts are encoded in
  fixed-size batches instead of a per-class Python loop.
- Split features (``utils.py:335-361``): encode + L2-normalize val/test once.

``encode_fn(images_u8) -> features`` takes a uint8 numpy batch and returns
features as a tensor (on any device) or an array; the normalization to the
model's input lives inside it.  The reductions here run in host numpy on the
fetched features.

``cache`` is a :class:`memory.cache.FeatureCache` (or ``None``: no
caching).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from protoclip_tpu_torch.memory.cache import FeatureCache
from protoclip_tpu_torch.tokenizer import EOT_ID, tokenize


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def encode_loader(
    encode_fn: Callable[[np.ndarray], Any],
    loader,
    normalize: bool = False,
    progress: Optional[str] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Encode every item in a loader -> (features fp32 (M, d), labels (M,))."""
    feats: List[np.ndarray] = []
    labels: List[np.ndarray] = []
    iterator = loader
    if progress:
        try:
            from tqdm import tqdm

            iterator = tqdm(loader, total=len(loader), desc=progress)
        except ImportError:  # pragma: no cover
            pass
    for images, batch_labels, n_valid in iterator:
        batch = _to_numpy(encode_fn(images))[:n_valid]
        if normalize:
            # same math as ops.proto.l2_normalize (x / ||x||, no eps)
            batch = batch / np.linalg.norm(batch, axis=-1, keepdims=True)
        feats.append(batch)
        labels.append(np.asarray(batch_labels[:n_valid]))
    return np.concatenate(feats), np.concatenate(labels)


def _orient_rows(mat: np.ndarray, n_rows: int) -> np.ndarray:
    """Resolve the reference's transposed cache layout.

    The reference stores the visual bank as ``(d, N*K)`` and the textual bank
    as ``(d, N)`` (``utils.py:318-330, 256-273``); we consume row-major.  A
    shape test disambiguates rectangular matrices; square ones (``N*K == d``)
    are resolved by content — rows of the correctly-oriented bank are
    L2-normalized, so pick the orientation whose row norms deviate least
    from 1.
    """
    if mat.shape[0] != mat.shape[1]:
        return mat if mat.shape[0] == n_rows else mat.T
    row_dev = float(np.abs(np.linalg.norm(mat, axis=1) - 1.0).mean())
    col_dev = float(np.abs(np.linalg.norm(mat, axis=0) - 1.0).mean())
    return mat if row_dev <= col_dev else mat.T


def build_visual_memory_bank(
    encode_fn,
    loader,
    augment_epochs: int,
    cache: Optional[FeatureCache] = None,
    progress: bool = True,
    expected_classes: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Build (or load) the visual memory bank.

    Returns ``keys (N*K, d)`` L2-normalized label-sorted features and
    ``values (N*K, N)`` one-hot labels.

    ``expected_classes``: dataset-variant guard, same hazard as
    :func:`pre_load_features` — the cache stems carry only backbone+shots,
    and e.g. the 52- and 198-class FewSOL variants share ``caches/fewsol``,
    so a cached bank from the other variant must be rejected and rebuilt,
    not silently adopted.
    """
    if cache is not None:
        key_stem, value_stem = cache.visual_bank_stems(augment_epochs)
        cached_k, cached_v = cache.load(key_stem), cache.load(value_stem)
        if cached_k is not None and cached_v is not None:
            keys = cached_k.get("keys", cached_k.get("array"))
            values = cached_v.get("values", cached_v.get("array"))
            if keys is not None and values is not None:
                keys = np.asarray(keys, np.float32)
                values = np.asarray(values, np.float32)
                if (
                    expected_classes is not None
                    and values.shape[1] != expected_classes
                ):
                    import sys

                    print(
                        f"[protoclip_tpu_torch] cached visual bank has "
                        f"{values.shape[1]} classes, expected "
                        f"{expected_classes} (different dataset variant?); "
                        "rebuilding",
                        file=sys.stderr,
                    )
                else:
                    # reference stores keys transposed (d, N*K); values' row
                    # count is the ground truth for N*K
                    keys = _orient_rows(keys, values.shape[0])
                    return keys, values

    if getattr(loader, "shuffle", False):
        raise ValueError(
            "build_visual_memory_bank needs a deterministic-order loader: "
            "features are averaged POSITIONALLY across augment passes, and a "
            "reshuffling loader would average different images together "
            "(the reference iterates its train loader unshuffled too, "
            "utils.py:308)"
        )
    sum_feats: Optional[np.ndarray] = None
    labels: Optional[np.ndarray] = None
    for aug in range(augment_epochs):
        feats, batch_labels = encode_loader(
            encode_fn, loader, normalize=False,
            progress=f"visual bank aug {aug + 1}/{augment_epochs}" if progress else None,
        )
        sum_feats = feats if sum_feats is None else sum_feats + feats
        if labels is None:
            labels = batch_labels
    assert sum_feats is not None and labels is not None

    mean = sum_feats / float(augment_epochs)
    mean /= np.linalg.norm(mean, axis=-1, keepdims=True)
    order = np.argsort(labels, kind="stable")
    keys = mean[order].astype(np.float32)
    sorted_labels = labels[order]
    n_class = int(sorted_labels.max()) + 1
    values = np.eye(n_class, dtype=np.float32)[sorted_labels]

    if cache is not None:
        key_stem, value_stem = cache.visual_bank_stems(augment_epochs)
        cache.save(key_stem, keys=keys)
        cache.save(value_stem, values=values)
    return keys, values


def build_textual_memory_bank(
    encode_text_fn,
    classnames: Sequence[str],
    template: Sequence[str],
    cache: Optional[FeatureCache] = None,
    batch_size: int = 512,
    context_length: int = 77,
) -> np.ndarray:
    """Build (or load) the textual memory bank -> ``(N, d)`` fp32.

    Batched encodes over all ``N * T`` ensemble prompts, then the
    reference's normalize -> mean -> normalize reduction per class.
    """
    if cache is not None:
        cached = cache.load(cache.text_bank_stem())
        if cached is not None:
            bank = cached.get("bank", cached.get("array"))
            if bank is not None:
                bank = np.asarray(bank, np.float32)
                # dataset-variant guard (see build_visual_memory_bank).
                # Prefer the stored n_class field (written by our save
                # below): the post-orientation shape heuristic alone can be
                # fooled when the stale bank's embed dim happens to equal
                # the expected class count.  Reference-produced caches lack
                # the field and fall back to the heuristic.
                stored_n = cached.get("n_class")
                if stored_n is not None and int(stored_n) != len(classnames):
                    bank = None
                else:
                    # reference stores the bank transposed (d, N)
                    bank = _orient_rows(bank, len(classnames))
                    if bank.shape[0] != len(classnames):
                        bank = None
                if bank is None:
                    import sys

                    print(
                        "[protoclip_tpu_torch] cached textual bank does not match "
                        f"the expected {len(classnames)} classes (different "
                        "dataset variant?); rebuilding",
                        file=sys.stderr,
                    )
                else:
                    return bank

    prompts = [
        t.format(name.replace("_", " ")) for name in classnames for t in template
    ]
    tokens = tokenize(prompts, context_length=context_length)
    n_class, n_templates = len(classnames), len(template)

    feats: List[np.ndarray] = []
    # pad to full batches so every encode sees one shape
    n_total = tokens.shape[0]
    n_pad = (-n_total) % batch_size
    if n_pad:
        tokens = np.concatenate([tokens, np.zeros((n_pad, tokens.shape[1]), tokens.dtype)])
        # EOT in column 0 so the argmax gather stays in range for pad rows;
        # the constant needs no vocab file
        tokens[n_total:, 0] = EOT_ID
    for start in range(0, tokens.shape[0], batch_size):
        feats.append(_to_numpy(encode_text_fn(tokens[start : start + batch_size])))
    flat = np.concatenate(feats)[:n_total]

    emb = flat.reshape(n_class, n_templates, -1)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    bank = emb.mean(axis=1)
    bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
    bank = bank.astype(np.float32)

    if cache is not None:
        # n_class stored alongside: the load-time variant guard above
        # validates it instead of relying on shape heuristics
        cache.save(
            cache.text_bank_stem(), bank=bank,
            n_class=np.asarray(n_class, np.int64),
        )
    return bank


def pre_load_features(
    encode_fn,
    loader,
    split: str,
    cache: Optional[FeatureCache] = None,
    progress: bool = True,
    expected_count: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Encode + L2-normalize an eval split once, with caching
    (ref ``utils.py:335-361``).

    ``expected_count``: number of items the split SHOULD have.  The
    reference's cache stems carry no dataset-variant marker (e.g. the
    52- and 198-class FewSOL runs share ``caches/fewsol``), so a cached
    file from a different variant would silently poison the run — a row
    count mismatch rejects it and recomputes instead.
    """
    if cache is not None:
        f_stem, l_stem = cache.split_stems(split)
        cf, cl = cache.load(f_stem), cache.load(l_stem)
        if cf is not None and cl is not None:
            feats = cf.get("features", cf.get("array"))
            labels = cl.get("labels", cl.get("array"))
            if feats is not None and labels is not None:
                feats = np.asarray(feats, np.float32)
                labels = np.asarray(labels, np.int64)
                if expected_count is not None and len(feats) != expected_count:
                    import sys

                    print(
                        f"[protoclip_tpu_torch] cached {split} features have "
                        f"{len(feats)} rows, expected {expected_count} "
                        "(different dataset variant?); recomputing",
                        file=sys.stderr,
                    )
                else:
                    return feats, labels

    feats, labels = encode_loader(
        encode_fn, loader, normalize=True, progress=f"{split} features" if progress else None
    )
    if cache is not None:
        f_stem, l_stem = cache.split_stems(split)
        cache.save(f_stem, features=feats)
        cache.save(l_stem, labels=labels)
    return feats, labels
