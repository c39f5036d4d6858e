"""Proto-CLIP train/test CLI (counterpart of ``protoclip_tpu/cli/main.py``;
flags mirror ``main.py:24-49``, ``--qt`` selects the F-Q^T trainer in place
of a separate ``main.qt.py``).

Zero-shot + fine-tune caltech101 at its tuned operating point::

    python -m protoclip_tpu_torch.cli.main --config configs/caltech101.yml \
        --dataset caltech101 [--qt] [--snapshot_every N] [--resume] [--device cpu]

Test-only with a checkpoint triple::

    python -m protoclip_tpu_torch.cli.main --config configs/fewsol_198.yml \
        --dataset fewsol_198 --only_test

``--device`` (default ``cuda``) takes the place of JAX's platform choice;
without CUDA the default raises.  ``--mesh N`` shards the encodes (and
the Q^T steps) over the first N devices; ``--multihost`` joins a
``torch.distributed`` group first (``parallel.init_distributed``: from
``torchrun``'s environment or ``$PROTOCLIP_COORDINATOR`` /
``$PROTOCLIP_NUM_PROCESSES`` / ``$PROTOCLIP_PROCESS_ID``), and ``--mesh``
then counts every process's devices::

    torchrun --nproc_per_node 8 -m protoclip_tpu_torch.cli.main \
        --config configs/imagenet.yml --dataset imagenet --qt --multihost --mesh 8
"""

from __future__ import annotations

import argparse

import torch

from protoclip_tpu_torch.core.config import load_config


def get_arguments(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Proto-CLIP trainer on PyTorch/CUDA")
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
    parser.add_argument("--snapshot_every", type=int,
                        help="snapshot the whole trainer state (params, AdamW, epoch) every N "
                        "epochs for preemption recovery (0 = off)")
    parser.add_argument("--resume", action="store_true", default=None,
                        help="resume from the operating point's trainer-state snapshot if one "
                        "exists (replay-exact: the episodes and batches of an uninterrupted run)")
    parser.add_argument("--qt", action="store_true", help="use the F-Q^T trainer (main.qt.py)")
    parser.add_argument("--mesh", type=int, default=0,
                        help="shard batches over N devices (0 = no mesh)")
    parser.add_argument("--multihost", action="store_true",
                        help="join a multi-process group before any computation "
                        "(parallel.mesh.init_distributed; from torchrun's environment or "
                        "$PROTOCLIP_COORDINATOR/$PROTOCLIP_NUM_PROCESSES/$PROTOCLIP_PROCESS_ID). "
                        "Combine with --mesh <total devices of every process>.")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card; with --mesh the "
                        "mesh's devices are the card's)")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = get_arguments(argv)
    # every flag passed applies, zeros included (the reference filters by
    # truthiness, main.py:56-63, and drops an explicit --alpha 0)
    overrides = {k: v for k, v in vars(args).items()
                 if k not in ("config", "qt", "mesh", "multihost", "device") and v is not None}
    if args.multihost:
        # before load_config and any CUDA call: the process's card is set
        # from $LOCAL_RANK before the group forms
        from protoclip_tpu_torch.parallel import init_distributed

        try:
            up = init_distributed()
        except ValueError as exc:  # a partial cluster spec: say what is missing
            raise SystemExit(f"--multihost: {exc}")
        if not up:
            raise SystemExit(
                "--multihost: no cluster found (set $PROTOCLIP_COORDINATOR / "
                "$PROTOCLIP_NUM_PROCESSES / $PROTOCLIP_PROCESS_ID or launch with torchrun)"
            )
    cfg = load_config(args.config, **overrides)
    if not cfg.dataset:
        raise SystemExit("Please provide a dataset (--dataset or config key)")

    mesh = None
    if args.mesh:
        from protoclip_tpu_torch.parallel import make_mesh

        devices = None if torch.device(args.device).type == "cuda" else [args.device] * args.mesh
        mesh = make_mesh(args.mesh, devices=devices)

    print("Running config:")
    for key, value in sorted(cfg.to_dict().items()):
        print(f"  {key}: {value}")

    if args.qt:
        from protoclip_tpu_torch.train.qt_runner import run_qt

        result = run_qt(cfg, device=None if mesh else args.device, mesh=mesh)
    else:
        from protoclip_tpu_torch.train.runner import run

        result = run(cfg, device=None if mesh else args.device, mesh=mesh)
    print(
        f"RESULT dataset={cfg.dataset} test_acc_fixed={result.test_acc_fixed*100:.2f}% "
        f"test_acc_searched={result.test_acc_searched*100:.2f}%"
    )


if __name__ == "__main__":
    main()
