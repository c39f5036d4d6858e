"""Training quickstart: the full Proto-CLIP-F experiment on synthetic data
(the port's counterpart of ``examples/train_quickstart.py``).

Self-contained: builds a 3-class synthetic dataset in the CoOp layout and
a tiny random CLIP checkpoint in the torch state-dict layout, then runs the
exact experiment flow of the reference's ``main.py``: memory banks ->
zero-shot alpha/beta sweep -> episodic training -> checkpoint -> test, and
finally loads the written ``_v/_t/_a`` checkpoint triple back through the
deployment classifier.  Runs on the card by default, or on the CPU in
about a minute::

    python -m protoclip_tpu_torch.examples.train_quickstart [--device cpu]

On real data this is just::

    python -m protoclip_tpu_torch.cli.main --config configs/caltech101.yml \
        --dataset caltech101 --root_path DATA/
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import tempfile

import numpy as np

# CLIP's vocabulary: the banks pad prompt batches with its EOT id 49407, which
# then has a row of its own, as in CLIP's weights (past a smaller table both
# packages' text towers clamp it to the last row)
CLIP_VOCAB = 49408


def tiny_clip_state_dict(rng, n_px: int = 32) -> dict:
    """Random torch-layout ViT CLIP weights (patch 16, width 64, embed 32)
    as float32 tensors, at ``n_px`` pixels."""
    import torch

    width, layers, patch, embed = 64, 2, 16, 32
    grid = n_px // patch
    # ctx 32: roomy enough for byte-level fallback tokenization of the
    # "a photo of a <class>." prompts
    twidth, tlayers, ctx = 64, 2, 32

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.05

    sd = {
        "visual.conv1.weight": randn(width, 3, patch, patch),
        "visual.class_embedding": randn(width),
        "visual.positional_embedding": randn(grid * grid + 1, width),
        "visual.ln_pre.weight": np.ones(width, np.float32),
        "visual.ln_pre.bias": np.zeros(width, np.float32),
        "visual.ln_post.weight": np.ones(width, np.float32),
        "visual.ln_post.bias": np.zeros(width, np.float32),
        "visual.proj": randn(width, embed),
        "token_embedding.weight": randn(CLIP_VOCAB, twidth),
        "positional_embedding": randn(ctx, twidth),
        "ln_final.weight": np.ones(twidth, np.float32),
        "ln_final.bias": np.zeros(twidth, np.float32),
        "text_projection": randn(twidth, embed),
        "logit_scale": np.asarray(np.log(1 / 0.07), np.float32),
    }
    for tower, n, w in (("visual.transformer", layers, width),
                        ("transformer", tlayers, twidth)):
        for i in range(n):
            p = f"{tower}.resblocks.{i}"
            sd[f"{p}.ln_1.weight"] = np.ones(w, np.float32)
            sd[f"{p}.ln_1.bias"] = np.zeros(w, np.float32)
            sd[f"{p}.attn.in_proj_weight"] = randn(3 * w, w)
            sd[f"{p}.attn.in_proj_bias"] = randn(3 * w)
            sd[f"{p}.attn.out_proj.weight"] = randn(w, w)
            sd[f"{p}.attn.out_proj.bias"] = randn(w)
            sd[f"{p}.ln_2.weight"] = np.ones(w, np.float32)
            sd[f"{p}.ln_2.bias"] = np.zeros(w, np.float32)
            sd[f"{p}.mlp.c_fc.weight"] = randn(4 * w, w)
            sd[f"{p}.mlp.c_fc.bias"] = randn(4 * w)
            sd[f"{p}.mlp.c_proj.weight"] = randn(w, 4 * w)
            sd[f"{p}.mlp.c_proj.bias"] = randn(w)
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def build_synthetic_dataset(root: str, rng) -> str:
    """3 'classes' (color families) in the caltech-101 CoOp layout."""
    from PIL import Image

    img_dir = os.path.join(root, "caltech-101", "101_ObjectCategories")
    rows = {"train": [], "val": [], "test": []}
    colors = [(200, 30, 30), (30, 200, 30), (30, 30, 200)]
    for c, cname in enumerate(["redthing", "greenthing", "bluething"]):
        os.makedirs(os.path.join(img_dir, cname))
        idx = 0
        for split, count in (("train", 6), ("val", 4), ("test", 4)):
            for _ in range(count):
                rel = f"{cname}/{idx}.jpg"
                img = np.clip(
                    np.asarray(colors[c], np.uint8)[None, None]
                    + rng.integers(0, 50, (40, 40, 3)),
                    0, 255,
                ).astype(np.uint8)
                Image.fromarray(img).save(os.path.join(img_dir, rel))
                rows[split].append([rel, c, cname])
                idx += 1
    split_path = os.path.join(root, "caltech-101", "split_zhou_Caltech101.json")
    with open(split_path, "w") as fh:
        json.dump(rows, fh)
    return split_path


def config_fields(tmp: str, root: str, weights: str) -> dict:
    """The experiment's operating point, with its caches and logs under
    ``tmp``."""
    return dict(
        dataset="caltech101", root_path=root, shots=2,
        backbone="tiny", weights_path=weights,
        lr=1e-3, augment_epoch=2, train_epoch=5,
        alpha=0.5, beta=5.0, adapter="fc", batch_size=8,
        cache_root=os.path.join(tmp, "caches"),
        logs_dir_path=os.path.join(tmp, "logs"),
        compute_dtype="float32",
    )


def ensure_demo_vocab(tmp: str) -> None:
    """The textual memory bank tokenizes classnames; if the real CLIP BPE
    vocab is not installed (~/.cache/clip or $PROTOCLIP_BPE_PATH), fall back
    to a header-only merge table = byte-level tokenization: fine for this
    random-weights demo, not for real checkpoints."""
    from protoclip_tpu_torch.tokenizer import default_vocab_path

    try:
        default_vocab_path()
    except FileNotFoundError:
        mini = os.path.join(tmp, "mini_vocab.txt.gz")
        with gzip.open(mini, "wt", encoding="utf-8") as fh:
            fh.write("#version: header-only demo vocab (byte-level BPE)\n")
        os.environ["PROTOCLIP_BPE_PATH"] = mini
        print("[quickstart] no CLIP BPE vocab found; using a byte-level demo tokenizer")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    args = parser.parse_args(argv)

    import torch

    from protoclip_tpu_torch.core.config import Config
    from protoclip_tpu_torch.device import resolve_device
    from protoclip_tpu_torch.toolkit import ProtoClipClassifier
    from protoclip_tpu_torch.train.runner import run

    device = resolve_device(args.device)
    tmp = tempfile.mkdtemp(prefix="protoclip_train_qs_")
    rng = np.random.default_rng(0)
    ensure_demo_vocab(tmp)

    weights = os.path.join(tmp, "tiny_clip.pt")
    torch.save(tiny_clip_state_dict(rng), weights)
    root = os.path.join(tmp, "DATA")
    split_path = build_synthetic_dataset(root, rng)
    print(f"[quickstart] synthetic dataset + tiny weights under {tmp} (device {device})")

    cfg = Config(**config_fields(tmp, root, weights))
    result = run(cfg, progress=False, device=device)
    print(f"[quickstart] zero-shot sweep best val acc: "
          f"{result.zero_shot['val_best_acc']:.3f}")
    print(f"[quickstart] trained test acc fixed(a={cfg.alpha}, b={cfg.beta}): "
          f"{result.test_acc_fixed:.3f}  searched: {result.test_acc_searched:.3f}")

    # the checkpoint triple, torch-format in the reference cache tree
    pattern = os.path.join(
        cfg.cache_dir, "models", "*", "K-*", "alpha-beta", "*", "best_lr_*_v.pt"
    )
    ckpts = sorted(glob.glob(pattern))
    print(f"[quickstart] checkpoint triple: {ckpts[0]}")

    # deploy route: load the written artifacts through the toolkit classifier
    clf = ProtoClipClassifier(
        cfg, splits_path=split_path,
        memory_bank_v_path=ckpts[0],
        memory_bank_t_path=ckpts[0].replace("_v.pt", "_t.pt"),
        adapter_weights_path=ckpts[0].replace("_v.pt", "_a.pt"),
        max_batch=4, device=device,
    )
    crop = np.clip(
        np.asarray((200, 30, 30), np.uint8)[None, None]
        + rng.integers(0, 50, (40, 40, 3)), 0, 255,
    ).astype(np.uint8)
    names, probs = clf.classify_objects([crop])
    print(f"[quickstart] deploy classify: top-k {names[0]} "
          f"probs {[round(float(p), 3) for p in probs[0]]}")


if __name__ == "__main__":
    main()
