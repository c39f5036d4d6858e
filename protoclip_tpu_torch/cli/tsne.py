"""Prototype t-SNE CLI (counterpart of ``protoclip_tpu/cli/tsne.py``; ref
``toolkit/.../utils/tsne.py`` CLI).  Host numpy only: it runs on no device.

Examples::

    # labeled scatter of trained prototypes
    python -m protoclip_tpu_torch.cli.tsne --config configs/fewsol.yml \
        --splits splits/fewsol_splits_198.json --out tsne.png \
        --memory_bank_v ... --memory_bank_t ...

    # reference-style thumbnail rendering (one support image per class at
    # its t-SNE coordinate); --after_train switches label placement between
    # the reference's plot_tsne_before / plot_tsne_after styles
    python -m protoclip_tpu_torch.cli.tsne ... --thumbnails --image_root DATA/fewsol \
        [--after_train]

For the before-training plot, pass the *cached* pre-training banks (the
``aug/visual_mb_keys_*.pt``/``text_mb_*.pkl`` artifacts the reference's
``build_cache_model`` produces, ``tsne.py:135-144``) as the bank paths; for
after-training, pass the trained ``best_..._v.pt``/``_t.pt`` checkpoints.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from protoclip_tpu_torch.core.config import load_config


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Proto-CLIP prototype t-SNE")
    parser.add_argument("--config", required=True)
    parser.add_argument("--splits", required=True, help="split JSON for classnames")
    parser.add_argument("--memory_bank_v", required=True)
    parser.add_argument("--memory_bank_t", required=True)
    parser.add_argument("--out", default="tsne.png")
    parser.add_argument("--perplexity", type=float, default=10.0)
    parser.add_argument(
        "--thumbnails", action="store_true",
        help="render one support image per class at its t-SNE coordinate "
        "(ref toolkit/.../utils/tsne.py:60-123)",
    )
    parser.add_argument(
        "--after_train", action="store_true",
        help="after-training label style (ref tsne.py plot_tsne_after); "
        "default is the before-training style (plot_tsne_before)",
    )
    parser.add_argument(
        "--image_root", default="",
        help="prefix for the split JSON's relative image paths (thumbnails)",
    )
    args = parser.parse_args(argv)

    cfg = load_config(args.config)
    from protoclip_tpu_torch.io.checkpoint import load_checkpoint_triple
    from protoclip_tpu_torch.toolkit.tsne import (
        plot_prototype_tsne,
        plot_prototype_tsne_thumbnails,
        representative_images_from_split,
    )

    bank_v, bank_t, _ = load_checkpoint_triple(args.memory_bank_v, args.memory_bank_t, None)
    n_class = bank_t.shape[0]
    # host numpy: trivial math, the same as the JAX CLI's
    zs = np.asarray(bank_v, np.float32).reshape(n_class, cfg.shots, -1)
    zs /= np.maximum(np.linalg.norm(zs, axis=-1, keepdims=True), 1e-12)
    img_protos = zs.mean(axis=1)
    img_protos /= np.maximum(np.linalg.norm(img_protos, axis=-1, keepdims=True), 1e-12)
    text_protos = np.asarray(bank_t, np.float32)
    # same zero-norm guard as the visual side: an all-zero bank row (class
    # absent from a partial artifact) must not NaN-poison the t-SNE
    text_protos /= np.maximum(
        np.linalg.norm(text_protos, axis=-1, keepdims=True), 1e-12
    )

    with open(args.splits) as fh:
        data = json.load(fh)
    id_map = {int(row[1]): row[2] for row in data["train"]}
    classnames = [id_map.get(i, str(i)) for i in range(n_class)]

    if args.thumbnails:
        image_paths = representative_images_from_split(args.splits, args.image_root)
        out = plot_prototype_tsne_thumbnails(
            img_protos, text_protos, classnames, image_paths, args.out,
            after_train=args.after_train, perplexity=args.perplexity,
        )
    else:
        out = plot_prototype_tsne(
            img_protos, text_protos, classnames, args.out, perplexity=args.perplexity
        )
    print(f"Wrote {out}")


if __name__ == "__main__":
    main()
