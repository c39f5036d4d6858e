"""Paper-figure generation over the port's classifier (counterpart of
``protoclip_tpu/toolkit/paper_figures.py``; ref ``toolkit/.../paper_diagram_generator.py``):
render top-k prediction canvases for fixed evaluation image sets."""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
from PIL import Image

from protoclip_tpu_torch.toolkit.classifier import ProtoClipClassifier

# The paper's fixed FewSOL evaluation sets: figure-row -> test-split row
# indices (ref ``paper_diagram_generator.py:10-19`` — defined twice there,
# identically; carried once here).
FEWSOL_PAPER_SETS = {
    1: [2, 6, 15, 26],
    2: [0, 13, 16, 18],
    3: [3, 14, 17, 24],
    4: [7, 10, 25, 31],
    5: [4, 5, 11, 29],
    6: [8, 19, 20, 23],
    7: [1, 12, 22, 27],
    8: [9, 21, 28, 30],
}


def paper_set_groups(split: dict, data_dir: str):
    """(image path groups, ground-truth name groups) for the paper's fixed
    sets, from a CoOp-format split dict (ref
    ``paper_diagram_generator.py:55-63``: test rows indexed by
    ``FEWSOL_PAPER_SETS``, classnames displayed with underscores as
    spaces)."""
    test_rows = split["test"]
    groups, gts = [], []
    for set_idx in sorted(FEWSOL_PAPER_SETS):
        rows = [test_rows[i] for i in FEWSOL_PAPER_SETS[set_idx]]
        groups.append([os.path.join(data_dir, r[0]) for r in rows])
        gts.append([str(r[2]).replace("_", " ") for r in rows])
    return groups, gts


def generate_prediction_figures(
    classifier: ProtoClipClassifier,
    image_groups: Sequence[Sequence[str]],
    out_dir: str,
    ground_truths: Optional[Sequence[Sequence[str]]] = None,
) -> List[str]:
    """For each group of image paths, classify and render a canvas PNG.

    Returns the list of written file paths.  ``ground_truths`` (parallel to
    ``image_groups``) highlights the true class in each panel.
    """
    os.makedirs(out_dir, exist_ok=True)
    written: List[str] = []
    for gi, group in enumerate(image_groups):
        crops = [np.asarray(Image.open(p).convert("RGB")) for p in group]
        names, probs = classifier.classify_objects(crops, log=False)
        gts = list(ground_truths[gi]) if ground_truths is not None else None
        canvas, _ = classifier.draw_image_with_top_k_images(crops, names, probs, gts)
        path = os.path.join(out_dir, f"prediction_group_{gi}.png")
        canvas.save(path)
        written.append(path)
    return written
