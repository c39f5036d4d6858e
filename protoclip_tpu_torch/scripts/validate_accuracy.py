"""Run every benchmark operating point and write the accuracy table (the
port's counterpart of ``scripts/validate_accuracy.py``).

The accuracy-parity north star needs real CLIP weights and datasets; this
harness is the one-shot runner for environments that have them::

    python -m protoclip_tpu_torch.scripts.validate_accuracy [--data-root DATA] \
        [--mesh N] [--only caltech101,dtd,...] [--out ACCURACY.md] [--int8] \
        [--set key=value ...] [--device cpu]

For each ``configs/<dataset>.yml`` it runs the full experiment at the tuned
operating point (reference protocol: K=16, tuned alpha/beta/adapter) and
records fixed-HP and searched-HP test accuracy into a markdown table (plus
a machine-readable ``<out>.json``).  Datasets whose raw data is missing are
skipped with the reason recorded, and any other failure is recorded as an
``ERROR`` row, so a partial data tree still yields a useful report.

``--int8`` additionally re-runs each dataset through the W8A8 serving
encode (K3, the mode passed down to the runner explicitly; a separate cache
tree) and records the int8 test accuracy and its delta: the per-dataset
operating-point re-validation to make before deploying the int8 serving
mode.

``--set key=value`` overrides any config field for every dataset (values
are YAML-parsed).  ``--device`` (default: the card) is where the runs go;
with ``--mesh N`` the encodes shard over N devices of that type.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from protoclip_tpu_torch.scripts._env import ensure_bpe_vocab

DATASETS = [
    "caltech101", "dtd", "eurosat", "fgvc", "food101", "imagenet",
    "oxford_flowers", "oxford_pets", "stanford_cars", "sun397", "ucf101",
    "fewsol", "fewsol_198",
]


def _parse_overrides(pairs):
    import yaml

    overrides = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"--set expects key=value, got {pair!r}")
        key, value = pair.split("=", 1)
        overrides[key.strip()] = yaml.safe_load(value)
    return overrides


def _run_one(cfg, mesh, device, int8, progress):
    from protoclip_tpu_torch.train.runner import run

    return run(cfg, progress=progress, device=None if mesh else device, mesh=mesh, int8=int8)


def _run_int8(cfg_path, base_overrides, data_root, mesh, device, progress):
    """Second pass through the W8A8 serving encode, in a separate cache tree
    so quantized features never poison the fp caches.  The mode goes down to
    ``run`` explicitly, so no process-wide setting decides it."""
    from protoclip_tpu_torch.core.config import load_config

    cfg = load_config(cfg_path, root_path=data_root, **base_overrides)
    cfg = load_config(
        cfg_path,
        root_path=data_root,
        **{**base_overrides, "cache_root": cfg.cache_root + "-int8"},
    )
    return _run_one(cfg, mesh, device, True, progress)


def _make_mesh(n, device):
    import torch

    from protoclip_tpu_torch.parallel import make_mesh

    devices = None if torch.device(device).type == "cuda" else [device] * n
    return make_mesh(n, devices=devices)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--data-root", default=os.environ.get("DATA_ROOT", "DATA"))
    parser.add_argument("--mesh", type=int, default=0)
    parser.add_argument("--only", help="comma-separated dataset subset")
    parser.add_argument("--out", default="ACCURACY.md")
    parser.add_argument("--config-dir", default="configs")
    parser.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE", dest="overrides",
        help="override a config field for every dataset (YAML-parsed value)",
    )
    parser.add_argument(
        "--int8", action="store_true",
        help="also re-validate each operating point through the W8A8 "
        "serving encode (separate cache tree; records acc delta)",
    )
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    args = parser.parse_args(argv)
    ensure_bpe_vocab()

    from protoclip_tpu_torch.core.config import load_config
    from protoclip_tpu_torch.device import resolve_device

    resolve_device(args.device)  # no card where one is asked for: raise before any run
    overrides = _parse_overrides(args.overrides)
    targets = args.only.split(",") if args.only else DATASETS
    rows = []
    records = []
    for name in targets:
        cfg_path = os.path.join(args.config_dir, f"{name}.yml")
        cfg = load_config(cfg_path, root_path=args.data_root, **overrides)
        start = time.time()
        record = {
            "dataset": name, "backbone": cfg.backbone, "alpha": cfg.alpha,
            "beta": cfg.beta, "adapter": cfg.adapter,
        }
        try:
            mesh = _make_mesh(args.mesh, args.device) if args.mesh else None

            # only_test configs (fewsol_198) evaluate the pretrained
            # checkpoint; the rest train at the tuned operating point
            result = _run_one(cfg, mesh, args.device, False, progress=True)
            record.update(
                test_acc_fixed=result.test_acc_fixed,
                test_acc_searched=result.test_acc_searched,
            )
            row = [
                name, cfg.backbone, cfg.alpha, cfg.beta, cfg.adapter,
                f"{result.test_acc_fixed * 100:.2f}",
                f"{result.test_acc_searched * 100:.2f}",
            ]
            if args.int8:
                r8 = _run_int8(cfg_path, overrides, args.data_root, mesh, args.device, True)
                delta = r8.test_acc_fixed - result.test_acc_fixed
                record.update(
                    test_acc_int8=r8.test_acc_fixed, int8_delta=delta
                )
                row += [f"{r8.test_acc_fixed * 100:.2f}", f"{delta * 100:+.2f}"]
            row.append(f"{time.time() - start:.0f}s")
            rows.append(tuple(row))
        except FileNotFoundError as exc:
            record["error"] = f"missing data: {exc}"
            rows.append(_pad_row(name, cfg, "skip", f"missing data: {exc}", args.int8))
        except Exception as exc:  # record and continue: partial tables are useful
            record["error"] = f"{type(exc).__name__}: {exc}"
            rows.append(
                _pad_row(name, cfg, "ERROR", f"{type(exc).__name__}: {exc}", args.int8)
            )
        records.append(record)
        _write(args.out, rows, args.int8)  # checkpoint the table per dataset
        with open(args.out + ".json", "w") as fh:
            json.dump(records, fh, indent=2)

    print(f"Wrote {args.out} ({len(rows)} rows)")


def _pad_row(name, cfg, marker, reason, int8):
    row = [name, cfg.backbone, cfg.alpha, cfg.beta, cfg.adapter, marker, marker]
    if int8:
        row += [marker, marker]
    row.append(reason)
    return tuple(row)


def _write(path: str, rows, int8: bool) -> None:
    cols = [
        "dataset", "backbone", "α", "β", "adapter",
        "test acc (fixed HP) %", "test acc (searched HP) %",
    ]
    if int8:
        cols += ["test acc (int8 W8A8) %", "Δ int8"]
    cols.append("wall")
    with open(path, "w") as fh:
        fh.write(
            "# ACCURACY — measured 16-shot test accuracy per operating point\n\n"
            "Produced by `python -m protoclip_tpu_torch.scripts.validate_accuracy`\n"
            "(reference protocol: K=16 shots, tuned alpha/beta/adapter from\n"
            "`configs/*.yml`).\n\n"
        )
        fh.write("| " + " | ".join(cols) + " |\n")
        fh.write("|" + "---|" * len(cols) + "\n")
        for r in rows:
            fh.write("| " + " | ".join(str(v) for v in r) + " |\n")


if __name__ == "__main__":
    sys.exit(main())
