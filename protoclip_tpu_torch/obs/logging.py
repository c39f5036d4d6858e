"""Metric logging (a copy of ``protoclip_tpu/obs/logging.py``): TensorBoard
events when available, JSONL always.

The JSONL sidecar (``metrics.jsonl``) makes runs greppable without
TensorBoard.
"""

from __future__ import annotations

import json
import os
import time


class MetricLogger:
    """Scalars to ``<log_dir>/metrics.jsonl`` (line-buffered) and, where
    ``torch.utils.tensorboard`` imports, to TensorBoard; images only there."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl_path = os.path.join(log_dir, "metrics.jsonl")
        # line-buffered: a crash/tunnel disconnect mid-run must not lose the log
        self._jsonl = open(self._jsonl_path, "a", buffering=1)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=log_dir)
        except ImportError:
            pass

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(
            json.dumps({"tag": tag, "value": float(value), "step": int(step), "t": time.time()})
            + "\n"
        )
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def image(self, tag: str, image_path: str, step: int = 0) -> None:
        if self._tb is not None:
            import numpy as np
            from PIL import Image

            arr = np.asarray(Image.open(image_path).convert("RGB")).transpose(2, 0, 1)
            self._tb.add_image(tag, arr, step)

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
