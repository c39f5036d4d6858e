"""t-SNE visualization of prototypes (a copy of ``protoclip_tpu/toolkit/
tsne.py``, host numpy; ref ``utils.py:125-164`` and
``toolkit/.../utils/tsne.py``): project image + text prototypes to 2-D and
render a labeled scatter (squares = image protos, plus-signs = text protos).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def _tsne_embed(img_protos: np.ndarray, text_protos: np.ndarray, perplexity: float):
    """Joint 2-D t-SNE of both prototype sets -> (zi (N, 2), zt (N, 2)).

    Shared by the scatter and thumbnail plots so the perplexity clamp and
    the reference's ``random_state=1`` pin (``toolkit/.../utils/tsne.py:65``)
    cannot diverge between them.  It runs in one OpenMP thread: sklearn's
    OpenMP pool spin-waits beside PyTorch's own pool in the same process,
    which on a loaded host slows the embedding by orders of magnitude,
    while one thread costs about a second at a few hundred points.  The
    embedding does not depend on the thread count."""
    from sklearn.manifold import TSNE
    from threadpoolctl import threadpool_limits

    img_protos = np.asarray(img_protos, np.float32)
    text_protos = np.asarray(text_protos, np.float32)
    n_class = img_protos.shape[0]
    X = np.vstack([img_protos, text_protos])
    tsne = TSNE(
        n_components=2,
        # sklearn requires perplexity < n_samples; the joint embedding has
        # 2*n_class rows (img + text prototypes), and the bound must stay
        # >= 1 so a single-class set still renders instead of raising
        perplexity=min(perplexity, max(1, 2 * n_class - 1)),
        random_state=1,
    )
    with threadpool_limits(limits=1, user_api="openmp"):
        emb = tsne.fit_transform(X)
    return emb[:n_class], emb[n_class:]


def plot_prototype_tsne(
    img_protos: np.ndarray,
    text_protos: np.ndarray,
    classnames: Sequence[str],
    out_path: str,
    perplexity: float = 10.0,
    title: str = "Proto-CLIP prototypes",
    logger=None,
    tag: str = "t-SNE/prototypes",
) -> str:
    """Write a t-SNE scatter PNG of the two prototype sets; returns the path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n_class = np.asarray(img_protos).shape[0]
    zi, zt = _tsne_embed(img_protos, text_protos, perplexity)

    colors = np.arange(n_class) / 10 + 0.05
    plt.figure(figsize=(8, 8))
    plt.scatter(zi[:, 0], zi[:, 1], c=colors, marker="s", label="image protos")
    plt.scatter(zt[:, 0], zt[:, 1], c=colors, marker="+", label="text protos")
    for i in range(n_class):
        plt.annotate(classnames[i], (zi[i, 0], zi[i, 1] + 0.2), fontsize=3)
        plt.annotate(classnames[i], (zt[i, 0], zt[i, 1] + 0.2), fontsize=3)
    plt.title(title)
    plt.axis("off")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    plt.savefig(out_path, dpi=300)
    plt.close()

    if logger is not None:
        logger.image(tag, out_path)
    return out_path


def representative_images_from_split(
    splits_path: str, image_root: str = "", shots: Optional[int] = None
) -> list:
    """One representative image path per class: the first train (support)
    image of each class id, in class-id order.

    Generalizes the reference's ``get_image_samples`` (``toolkit/.../utils/
    tsne.py:42-56``), which reads a pre-dumped ``image_locations.txt`` and
    picks row ``i*16`` — i.e. the first of each class's 16 support images.
    Here the paths come straight from the split JSON (rows are
    ``[path, class_id, classname]``), so no side file is needed and any
    shot count works (``shots`` is accepted for signature parity but the
    first-per-class rule makes it unnecessary)."""
    import json

    with open(splits_path) as fh:
        data = json.load(fh)
    first: dict = {}
    for path, class_id, _ in data["train"]:
        first.setdefault(int(class_id), os.path.join(image_root, path))
    if sorted(first) != list(range(len(first))):
        # the thumbnail plot indexes these positionally against prototype
        # row i == class id i; a split with gaps (a class without support
        # rows) would silently pair row i with the wrong class's image
        raise ValueError(
            f"train split class ids are not contiguous 0..{len(first) - 1}: "
            f"every class needs at least one support row for thumbnails"
        )
    return [first[i] for i in sorted(first)]


def plot_prototype_tsne_thumbnails(
    img_protos: np.ndarray,
    text_protos: np.ndarray,
    classnames: Sequence[str],
    image_paths: Sequence[str],
    out_path: str,
    after_train: bool = True,
    perplexity: float = 10.0,
    thumb_px: int = 48,
    figsize: float = 50.0,
    logger=None,
    tag: str = "t-SNE/prototypes-thumbnails",
) -> str:
    """Thumbnail t-SNE: render one support image at each class's 2-D image-
    prototype coordinate (ref ``toolkit/.../utils/tsne.py:60-123``,
    ``OffsetImage``/``AnnotationBbox`` at lines 79-83/106-110).

    ``after_train=True`` mirrors ``plot_tsne_after``: class names annotated
    at the image positions, text prototypes as aquamarine ``+`` markers.
    ``after_train=False`` mirrors ``plot_tsne_before``: unlabeled images,
    text prototypes as lightseagreen ``P`` markers carrying the labels.
    Thumbnails are resized with PIL (the reference uses cv2, an extra dep).
    Returns ``out_path``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.offsetbox import AnnotationBbox, OffsetImage
    from PIL import Image

    n_class = np.asarray(img_protos).shape[0]
    if len(image_paths) < n_class:
        raise ValueError(
            f"need one representative image per class: got {len(image_paths)} "
            f"paths for {n_class} classes"
        )
    zi, zt = _tsne_embed(img_protos, text_protos, perplexity)

    _, ax = plt.subplots(figsize=(figsize, figsize))
    for idx, (x, y) in enumerate(zip(zi[:, 0], zi[:, 1])):
        with Image.open(image_paths[idx]) as im:
            thumb = np.asarray(im.convert("RGB").resize((thumb_px, thumb_px)))
        ab = AnnotationBbox(OffsetImage(thumb), (x, y), frameon=False, zorder=1)
        ax.scatter(x, y, zorder=4, s=32, c="cyan", marker=".")
        ax.add_artist(ab)
        if after_train:
            ax.annotate(
                classnames[idx], xy=(x, y + 1), ha="center", c="crimson", fontsize=10
            )
    if after_train:
        ax.scatter(zt[:, 0], zt[:, 1], c="aquamarine", zorder=3, marker="+", s=128)
    else:
        ax.scatter(zt[:, 0], zt[:, 1], c="lightseagreen", zorder=3, marker="P", s=128)
        for i in range(min(n_class, len(classnames))):
            ax.annotate(
                classnames[i], (zt[i, 0], zt[i, 1] + 0.2), c="crimson", fontsize=25
            )
    ax.axis("off")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    plt.savefig(out_path, dpi=100)
    plt.close()

    if logger is not None:
        logger.image(tag, out_path)
    return out_path
