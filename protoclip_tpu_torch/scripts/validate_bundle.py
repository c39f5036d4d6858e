"""Validate the serving bundle on the card, end to end (the port's
counterpart of ``scripts/validate_bundle_tpu.py``).

Exports the flagship ViT-B/16 encoder as a serving bundle (bf16, or W8A8
with ``--int8``), reloads it cold -- the loader path a serving process
would use, one CUDA graph per batch bucket captured at load -- and checks:

1. the reloaded bundle's features match the live ``make_encode_fn`` path
   bit for bit (the same encode and the same weights: the export must not
   change numerics; the mode is passed down to both, no process-wide
   setting decides it);
2. each bucket's rows (``--buckets``) against the full batch's, within the
   JAX script's bars (1e-5 in bf16; 1e-2 and a row cosine >= 0.9995 in
   int8);
3. the replay's throughput on device-resident input: the full batch, then
   each bucket's ms per dispatch (one replay and the feature fetch).

    python -m protoclip_tpu_torch.scripts.validate_bundle [--int8] --buckets 8 64
    python -m protoclip_tpu_torch.scripts.validate_bundle --device cpu --batch 8

The bundle holds no compiled program, so the artifact size reported is
``params.npz``'s.  On the card the blocks run K2 (K3 with ``--int8``) and
the launches captured into each replay are printed; without ``--device
cpu`` the script raises where CUDA is absent.  A failed check prints
``FAIL`` and exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

# the JAX script's bars for a bucket's rows against the full batch's
# (``validate_bundle_tpu.py:132-150``): max |diff| by mode, and the row
# cosine floor
BUCKET_TOL = {False: 1e-5, True: 1e-2}
BUCKET_MIN_COSINE = 0.9995


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--backbone", default="ViT-B/16")
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--int8", action="store_true")
    parser.add_argument("--iters", type=int, default=8)
    parser.add_argument(
        "--buckets", type=int, nargs="*", default=None,
        help="also export bucketed batch sizes (e.g. --buckets 8 64) and "
        "validate each bucket's output + per-dispatch latency vs the max",
    )
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    return parser


def dispatch_ms(torch, art, rows: np.ndarray, iters: int) -> float:
    """Host wall ms of one dispatch of bucket ``art`` on device-resident
    input: on the card one replay of its graph on its input buffer (filled
    once, untimed) and the fetch of its features; on the CPU one eager
    call.  Two warm-up dispatches, then the mean of ``iters``."""
    if art.graph is None:
        def run_once():
            return art(rows)
    else:
        with torch.cuda.device(art.device), torch.cuda.stream(art.stream):
            art.input[:len(rows)].copy_(torch.from_numpy(rows))

        def run_once():
            with torch.cuda.device(art.device), torch.cuda.stream(art.stream):
                art.graph.replay()
                return art.output.cpu().numpy()

    for _ in range(2):
        run_once()
    t0 = time.perf_counter()
    for _ in range(iters):
        run_once()
    return (time.perf_counter() - t0) / iters * 1e3


def row_cosine_min(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.min(np.sum(a * b, axis=-1)
                        / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))))


def validate(args) -> dict:
    """Export, reload, check and time; returns ``{"line": the JSON line,
    "rows": the reloaded full batch, "failure": None or what failed,
    "per_replay": {bucket: launches}}``.  Stops at the first failed check."""
    import torch

    from protoclip_tpu_torch.device import resolve_device
    from protoclip_tpu_torch.io.export import (
        load_serving_bundle,
        make_encode_fn,
        save_serving_bundle,
    )
    from protoclip_tpu_torch.models import load_clip

    device = resolve_device(args.device)
    print(f"[bundle] backend={device.type} backbone={args.backbone} "
          f"batch={args.batch} int8={args.int8}")

    cfg, params = load_clip(args.backbone, dtype=torch.bfloat16, device=device, int8=args.int8)
    n_px = cfg.image_resolution
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (args.batch, n_px, n_px, 3)).astype(np.uint8)
    out = {"rows": None, "failure": None, "per_replay": {}}

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        save_serving_bundle(d, cfg, params, batch_size=args.batch,
                            batch_sizes=args.buckets, int8=args.int8)
        export_s = time.perf_counter() - t0
        artifact_kb = os.path.getsize(os.path.join(d, "params.npz")) / 1024
        print(f"[bundle] exported in {export_s:.1f}s, params.npz {artifact_kb:.0f} KB "
              "(no program: the graphs are captured at load)")

        encode = load_serving_bundle(d, device=device)
        got = encode(imgs)
        out["rows"] = got
        for size, art in sorted(encode.artifacts.items()):
            if art.graph is not None:
                out["per_replay"][size] = art.launches_per_replay
                print(f"[bundle] bucket {size}: launches per replay {art.launches_per_replay}")

        # the live path at the same serving mode, passed down explicitly
        live = make_encode_fn(cfg, int8=args.int8)
        want = live(params, torch.from_numpy(imgs).to(device)).cpu().numpy()
        max_abs = float(np.max(np.abs(got - want)))
        print(f"[bundle] reload-vs-live max|diff| = {max_abs:.3e}")
        if max_abs != 0.0:
            # the same encode and the same weights must be bit-identical
            out["failure"] = f"bundle output diverges from live path ({max_abs})"
            return out

        full = encode.artifacts[args.batch]
        dt = dispatch_ms(torch, full, imgs, args.iters) / 1e3
        line = {
            "bundle_images_per_sec_device_input": round(args.batch / dt, 1),
            "ms_per_batch": round(dt * 1e3, 2),
            "note": "per-dispatch (one batch per call): one CUDA graph replay on "
                    "device-resident input and the feature fetch (on the CPU one "
                    "eager call)",
        }

        # each bucket's rows against the full batch's; a bucket is the same
        # encode at another batch shape, so a bf16 row moves only within
        # the products' summation order, an int8 row by a quantization step
        tol = BUCKET_TOL[args.int8]
        for size in sorted(args.buckets or []):
            sub = encode(imgs[:size])
            bucket_max = float(np.max(np.abs(sub - got[:size])))
            cos = row_cosine_min(sub, got[:size])
            if bucket_max > tol or cos < BUCKET_MIN_COSINE:
                out["failure"] = (f"bucket {size} diverges from the max batch "
                                  f"(max|diff| = {bucket_max}, min row cosine = {cos})")
                return out
            print(f"[bundle] bucket {size}: max|diff| vs max batch = "
                  f"{bucket_max:.2e}, min row cosine = {cos:.6f}")
            line[f"bucket_{size}_ms_per_dispatch"] = round(
                dispatch_ms(torch, encode.artifacts[size], imgs[:size], args.iters), 2)
    out["line"] = line
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    result = validate(args)
    if result["failure"]:
        print(f"FAIL: {result['failure']}", file=sys.stderr)
        return 1
    print(json.dumps(result["line"]))
    print("[bundle] OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
