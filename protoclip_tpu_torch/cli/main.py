"""Proto-CLIP test CLI (counterpart of ``protoclip_tpu/cli/main.py``; flags
mirror ``main.py:24-49``).  Test-only with a checkpoint triple::

    python -m protoclip_tpu_torch.cli.main --config configs/fewsol_198.yml \
        --dataset fewsol_198 --only_test [--device cpu]

``--device`` (default ``cuda``) takes the place of JAX's platform choice;
without CUDA the default raises.  A run without ``--only_test`` (training),
``--qt``, ``--mesh``, ``--multihost``, ``--resume`` and ``--snapshot_every``
exit with a message naming the slice that brings them.
"""

from __future__ import annotations

import argparse

from protoclip_tpu_torch.core.config import load_config

LATER = {  # flag: the slice that brings it (ROADMAP.md, queue 1)
    "train": "item 4, the Proto-CLIP-F trainer",
    "qt": "item 4, the F-Q^T trainer",
    "resume": "item 4, the trainers' snapshots",
    "snapshot_every": "item 4, the trainers' snapshots",
    "mesh": "item 7, multi-GPU",
    "multihost": "item 7, multi-GPU",
}


def get_arguments(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Proto-CLIP on PyTorch/CUDA (test only)")
    parser.add_argument("--config", required=True, help="YAML config path")
    parser.add_argument("--dataset", help="dataset alias (see protoclip_tpu_torch.data.available_datasets)")
    parser.add_argument("--logs", dest="logs_dir_path", help="log directory")
    parser.add_argument("--alpha", type=float)
    parser.add_argument("--beta", type=float)
    parser.add_argument("--adapter", choices=["conv-3x", "conv-2x", "fc"])
    parser.add_argument("--train_vis_memory_only", dest="train_vis_mem_only", action="store_true",
                        default=None)
    parser.add_argument("--only_test", action="store_true", default=None)
    parser.add_argument("--shots", type=int)
    parser.add_argument("--losses", nargs="+")
    parser.add_argument("--backbone")
    parser.add_argument("--root_path")
    parser.add_argument("--batch_size", type=int)
    parser.add_argument("--train_epoch", type=int)
    parser.add_argument("--seed", type=int)
    parser.add_argument("--weights_path", help="CLIP weights .pt path")
    parser.add_argument("--snapshot_every", type=int, help=f"(not ported: {LATER['snapshot_every']})")
    parser.add_argument("--resume", action="store_true", default=None,
                        help=f"(not ported: {LATER['resume']})")
    parser.add_argument("--qt", action="store_true", help=f"(not ported: {LATER['qt']})")
    parser.add_argument("--mesh", type=int, default=0, help=f"(not ported: {LATER['mesh']})")
    parser.add_argument("--multihost", action="store_true",
                        help=f"(not ported: {LATER['multihost']})")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = get_arguments(argv)
    for flag in ("qt", "mesh", "multihost", "resume", "snapshot_every"):
        if getattr(args, flag):
            raise SystemExit(f"--{flag} is not ported yet; it comes with ROADMAP.md "
                             f"queue 1 {LATER[flag]}")
    # every flag passed applies, zeros included (the reference filters by
    # truthiness, main.py:56-63, and drops an explicit --alpha 0)
    overrides = {k: v for k, v in vars(args).items()
                 if k not in ("config", "qt", "mesh", "multihost", "device") and v is not None}
    cfg = load_config(args.config, **overrides)
    if not cfg.dataset:
        raise SystemExit("Please provide a dataset (--dataset or config key)")
    if not cfg.only_test:
        raise SystemExit("training is not ported yet (it comes with ROADMAP.md queue 1 "
                         f"{LATER['train']}); pass --only_test to test a checkpoint triple")

    print("Running config:")
    for key, value in sorted(cfg.to_dict().items()):
        print(f"  {key}: {value}")

    from protoclip_tpu_torch.train.runner import run

    result = run(cfg, device=args.device)
    print(
        f"RESULT dataset={cfg.dataset} test_acc_fixed={result.test_acc_fixed*100:.2f}% "
        f"test_acc_searched={result.test_acc_searched*100:.2f}%"
    )


if __name__ == "__main__":
    main()
