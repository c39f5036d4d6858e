"""OOD evaluation CLI (counterpart of ``protoclip_tpu/cli/ood.py``; ref
``toolkit`` OOD scripts).

Example::

    python -m protoclip_tpu_torch.cli.ood --config configs/imagenet.yml \
        --ood imagenet_sketch --data_root DATA/sketch \
        --memory_bank_v ... --memory_bank_t ... --adapter_weights ... [--device cpu]

``--device`` (default ``cuda``) takes the place of JAX's platform choice;
without CUDA the default raises.
"""

from __future__ import annotations

import argparse

from protoclip_tpu_torch.core.config import load_config


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Proto-CLIP OOD evaluation")
    parser.add_argument("--config", required=True)
    parser.add_argument("--ood", required=True, choices=["imagenet_v2", "imagenet_sketch"])
    parser.add_argument("--data_root", required=True, help="class-folder dataset root")
    parser.add_argument("--memory_bank_v")
    parser.add_argument("--memory_bank_t", required=True)
    parser.add_argument("--adapter_weights")
    parser.add_argument("--alpha", type=float)
    parser.add_argument("--beta", type=float)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    args = parser.parse_args(argv)

    cfg = load_config(args.config, alpha=args.alpha, beta=args.beta)
    from protoclip_tpu_torch.toolkit.ood import test_ood_performance
    from protoclip_tpu_torch.train.runner import make_encode_fns

    encode_fn, _, clip_cfg, _ = make_encode_fns(cfg, args.device)
    acc = test_ood_performance(
        cfg, args.ood, encode_fn, args.data_root,
        memory_bank_v_path=args.memory_bank_v,
        memory_bank_t_path=args.memory_bank_t,
        adapter_weights_path=args.adapter_weights,
        image_size=clip_cfg.image_resolution,
        device=args.device,
    )
    print(f"OOD {args.ood} accuracy: {acc:.2f}%")


if __name__ == "__main__":
    main()
