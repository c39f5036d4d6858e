"""Standalone CLIP feature extraction: image folder -> features ``.npz``
(counterpart of ``protoclip_tpu/cli/extract.py``).

    python -m protoclip_tpu_torch.cli.extract --backbone ViT-B/16 \
        --input path/to/images --out feats.npz [--int8] [--batch 512] [--mesh N] \
        [--device cpu]

Walks ``--input`` recursively for image files (sorted, stable order),
decodes the next batch on a thread pool while the current one encodes,
encodes fixed-size batches through the canonical serving encode (the W8A8
block K3 with ``--int8``), L2-normalizes, and writes ``{"files": [...],
"features": (N, d) fp32}``.

``--device`` (default ``cuda``) takes the place of JAX's platform
selection.  ``--int8`` runs K3's kernels on the card and K3's plain
PyTorch version on the CPU; it never falls back to bf16.  ``--mesh N``
shards every batch over the first N devices (weights copied to each once;
the batch rounded up to a multiple of N); each row is encoded as in the
unsharded run.
"""

from __future__ import annotations

import argparse
import os
import sys


def _find_images(root: str) -> list:
    from protoclip_tpu_torch.data.splits import _IMAGE_EXTS

    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for name in sorted(filenames):
            if name.lower().endswith(_IMAGE_EXTS):
                out.append(os.path.join(dirpath, name))
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--backbone", default="ViT-B/16")
    parser.add_argument("--weights", help="CLIP weights .pt (default: discovery)")
    parser.add_argument("--input", required=True, help="image file or directory")
    parser.add_argument("--out", required=True, help="output .npz path")
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--mesh", type=int, default=0,
                        help="shard encode batches over the first N devices (1-D 'data' mesh, "
                        "the layout of the experiment encode and of --mesh serving); "
                        "0 = one device")
    parser.add_argument("--device", default="cuda",
                        help="torch device to encode on (default: the card)")
    parser.add_argument("--int8", action="store_true",
                        help="W8A8 serving block (sets $PROTOCLIP_INT8)")
    parser.add_argument("--no-normalize", action="store_true",
                        help="skip output L2-normalization")
    parser.add_argument("--fast-decode", action="store_true",
                        help="libjpeg DCT-scaled decode (~2x faster host preprocess; not "
                        "pixel-exact with the torchvision pipeline; serving only)")
    parser.add_argument("--decode-threads", type=int, default=max(1, (os.cpu_count() or 1)),
                        help="host decode threads (PIL releases the GIL)")
    args = parser.parse_args()

    if args.int8:
        os.environ["PROTOCLIP_INT8"] = "1"

    import concurrent.futures as _futures

    import numpy as np
    import torch

    from protoclip_tpu_torch.data.transforms import clip_preprocess, load_image
    from protoclip_tpu_torch.io.checkpoint import replace_atomically
    from protoclip_tpu_torch.io.export import make_encode_fn
    from protoclip_tpu_torch.models.clip import load_clip

    if not args.out.endswith(".npz"):
        args.out += ".npz"  # np.savez appends it silently otherwise
    files = [args.input] if os.path.isfile(args.input) else _find_images(args.input)
    if not files:
        sys.exit(f"no images found under {args.input!r}")

    # fail fast on an unwritable --out before the encode work: the features
    # reach the disk only after the whole corpus is processed
    out_dir = os.path.dirname(os.path.abspath(args.out)) or "."
    os.makedirs(out_dir, exist_ok=True)
    if not os.access(out_dir, os.W_OK):
        raise SystemExit(f"[extract] --out directory is not writable: {out_dir}")

    device = torch.device(args.device)
    mesh = None
    if args.mesh:
        from protoclip_tpu_torch.parallel import (
            make_mesh,
            make_sharded_encode,
            mesh_batch,
            replicated,
        )

        mesh = make_mesh(args.mesh, devices=None if device.type == "cuda" else
                         [device] * args.mesh)
        device = mesh.device
        args.batch = mesh_batch(args.batch, mesh)
    cfg, params = load_clip(args.backbone, args.weights, dtype=torch.bfloat16, device=device)
    n_px = cfg.image_resolution
    encode_batch = make_encode_fn(cfg, normalize=not args.no_normalize)
    if mesh is None:
        def encode(p, block: np.ndarray) -> torch.Tensor:
            return encode_batch(p, torch.from_numpy(block).to(device))
    else:
        # each row depends only on its own image, so a shard's rows equal
        # the unsharded run's at the same per-shard batch; the weights are
        # copied to the mesh's devices once, not at every chunk
        params = replicated(mesh).put(params)
        encode = make_sharded_encode(encode_batch, mesh)
    draft_px = n_px if args.fast_decode else None

    def _decode(into, i, path):
        into[i] = clip_preprocess(load_image(path, draft_px), n_px)

    feats_out = []
    # double buffer: while chunk N encodes, the pool decodes chunk N+1 into
    # the other buffer.  Buffer ci % 2 is rewritten only for chunk ci + 2,
    # after chunk ci's features came back (its upload is long done).
    bufs = [np.zeros((args.batch, n_px, n_px, 3), np.uint8) for _ in range(2)]
    chunks = [files[s:s + args.batch] for s in range(0, len(files), args.batch)]
    with _futures.ThreadPoolExecutor(max_workers=args.decode_threads) as pool:

        def submit(ci):
            buf = bufs[ci % 2]
            return [pool.submit(_decode, buf, i, p) for i, p in enumerate(chunks[ci])]

        pending = submit(0)
        for ci, chunk in enumerate(chunks):
            for fut in pending:
                fut.result()  # barrier, and decode errors surface here
            # fixed batch shape whatever the tail; the kernels run async
            dev_feats = encode(params, bufs[ci % 2])
            if ci + 1 < len(chunks):
                pending = submit(ci + 1)
            feats_out.append(dev_feats.cpu().numpy()[:len(chunk)])
            print(f"\r[extract] {min((ci + 1) * args.batch, len(files))}/{len(files)}",
                  end="", file=sys.stderr)
    print(file=sys.stderr)

    features = np.concatenate(feats_out)
    # every process of a multi-process mesh writes the same file: each
    # through its own tmp file, renamed into place whole
    with replace_atomically(args.out) as tmp, open(tmp, "wb") as fh:
        np.savez(fh, files=np.asarray(files), features=features)  # a handle: no .npz appended
    print(f"Wrote {args.out}: {features.shape[0]} x {features.shape[1]} fp32")


if __name__ == "__main__":
    main()
