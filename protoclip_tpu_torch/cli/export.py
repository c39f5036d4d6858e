"""Export a serving bundle from the command line (counterpart of
``protoclip_tpu/cli/export.py``).

The workflow train -> export -> serve: the bundle directory this writes is
what ``python -m protoclip_tpu_torch.cli.serve --bundle`` loads (weights
npz + manifest, ``io/export.py``; the server captures one CUDA graph per
batch bucket when it loads the bundle).

    python -m protoclip_tpu_torch.cli.export --backbone ViT-B/16 --out bundle/ \
        --batch 256 --buckets 8 64 [--int8] [--device cpu]

Without ``--weights`` (or ``$PROTOCLIP_WEIGHTS_DIR``) the backbone is
initialized at random from seed 0, as ``load_clip`` does everywhere in the
port.  ``--device`` (default ``cuda``) is where the weights are loaded; the
JAX CLI's ``--platform`` has no counterpart, since a bundle holds no
compiled program.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--backbone", default="ViT-B/16")
    parser.add_argument("--weights", help="CLIP weights .pt path (default: discovery)")
    parser.add_argument("--out", required=True, help="bundle directory to write")
    parser.add_argument("--batch", type=int, default=256,
                        help="largest batch bucket")
    parser.add_argument(
        "--buckets", type=int, nargs="*", default=None,
        help="extra batch buckets (e.g. 8 64): calls route to the smallest "
        "bucket that fits, so underfull dispatches cost less",
    )
    parser.add_argument("--int8", action="store_true",
                        help="a W8A8 bundle (K3; the weights are quantized at load)")
    parser.add_argument("--no-normalize", action="store_true",
                        help="skip the L2 feature normalization")
    parser.add_argument("--device", default="cuda",
                        help="torch device to load the weights on (default: the card)")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    import torch

    from protoclip_tpu_torch.io.export import save_serving_bundle
    from protoclip_tpu_torch.models import load_clip

    cfg, params = load_clip(args.backbone, args.weights, dtype=torch.bfloat16,
                            device=args.device)
    save_serving_bundle(
        args.out, cfg, params,
        batch_size=args.batch,
        batch_sizes=args.buckets,
        int8=args.int8,
        normalize=not args.no_normalize,
    )
    sizes = sorted({args.batch, *(args.buckets or ())})
    print(
        f"Wrote {args.out}: {args.backbone} batch buckets {sizes} "
        f"{'int8' if args.int8 else 'bf16'}",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
