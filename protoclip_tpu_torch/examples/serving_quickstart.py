"""Serving quickstart: export a serving bundle, serve it over HTTP, query it
(the port's counterpart of ``examples/serving_quickstart.py``).

Self-contained: no datasets, no pretrained weights (a tiny random CLIP
checkpoint stands in; pass ``--backbone ViT-B/16`` to ``cli.export`` with
real weights on a real deployment).  Runs on the card by default, or on
the CPU in seconds::

    python -m protoclip_tpu_torch.examples.serving_quickstart [--device cpu]

What it demonstrates, end to end:

1. ``python -m protoclip_tpu_torch.cli.export``: weights + manifest as a
   bundle directory (``io/export.py``).
2. ``python -m protoclip_tpu_torch.cli.serve``: the stdlib HTTP front-end
   with dynamic request micro-batching (``cli/serve.py``); on the card it
   captures one CUDA graph per batch bucket.
3. ``ServeClient`` (``client.py``), whose rows equal a direct encode of the
   same images through the bundle (kept as ``served.npy`` beside the
   weights); then a graceful SIGTERM.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

from protoclip_tpu_torch.examples.train_quickstart import tiny_clip_state_dict

N_PX = 64


def export_bundle(tmp: str, device: str) -> str:
    """A tiny random checkpoint, exported by the export CLI (batch 8)."""
    import torch

    from protoclip_tpu_torch.cli.export import main as export_main

    weights = os.path.join(tmp, "tiny_clip.pt")
    torch.save(tiny_clip_state_dict(np.random.default_rng(0), n_px=N_PX), weights)
    bundle = os.path.join(tmp, "bundle")
    export_main(["--backbone", "tiny", "--weights", weights, "--out", bundle,
                 "--batch", "8", "--device", device])
    print(f"[quickstart] exported bundle -> {bundle}")
    return bundle


def direct_encode(bundle: str, crops, device: str) -> np.ndarray:
    """The same crops through the bundle in this process: the server's
    preprocess (``clip_preprocess``) and the bundle's encode."""
    from PIL import Image

    from protoclip_tpu_torch.data.transforms import clip_preprocess
    from protoclip_tpu_torch.io.export import load_serving_bundle

    encode = load_serving_bundle(bundle, device=device)
    return encode(np.stack([clip_preprocess(Image.fromarray(c), N_PX) for c in crops]))


def demo_crops() -> list:
    """Three random crops of different heights, from seed 0."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (48 + 8 * i, 64, 3), dtype=np.uint8) for i in range(3)]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (default: the card)")
    args = parser.parse_args(argv)

    from protoclip_tpu_torch.client import ServeClient, ServeError
    from protoclip_tpu_torch.device import resolve_device

    resolve_device(args.device)  # raises here, not in the server, without CUDA
    tmp = tempfile.mkdtemp(prefix="protoclip_qs_")
    bundle = export_bundle(tmp, args.device)

    with socket.socket() as s:  # pick a free port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    server = subprocess.Popen(
        [sys.executable, "-m", "protoclip_tpu_torch.cli.serve",
         "--bundle", bundle, "--port", str(port), "--device", args.device],
        env=dict(os.environ),
    )
    try:
        client = ServeClient(f"http://127.0.0.1:{port}")
        for _ in range(200):  # wait for the warm-up
            if server.poll() is not None:
                raise RuntimeError(f"the server exited with code {server.returncode}")
            try:
                health = client.healthz()
                break
            except (ServeError, OSError):
                time.sleep(0.3)
        else:
            raise RuntimeError("server never became healthy")
        print(f"[quickstart] healthz: {health}")

        crops = demo_crops()
        feats = client.encode(crops)
        print(f"[quickstart] encoded {feats.shape[0]} images -> "
              f"{feats.shape[1]}-d features; first row starts "
              f"{[round(float(v), 4) for v in feats[0, :4]]}")
        diff = float(np.abs(feats - direct_encode(bundle, crops, args.device)).max())
        print(f"[quickstart] served rows vs a direct encode: max |diff| = {diff}")
        if diff != 0.0:
            raise RuntimeError("the served rows differ from the direct encode")
        rows = os.path.join(tmp, "served.npy")
        np.save(rows, feats)
        print(f"[quickstart] served rows -> {rows}")
        print(f"[quickstart] statz: {client.statz()}")
    finally:
        server.send_signal(signal.SIGTERM)  # graceful: flush + exit 0
        print(f"[quickstart] server exit code: {server.wait(timeout=60)}")


if __name__ == "__main__":
    main()
