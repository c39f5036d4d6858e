"""Stdlib HTTP client for the serving front-end (``cli/serve.py``), a copy
of ``protoclip_tpu/client.py``: the port's server speaks the same protocol,
so either package's client talks to either server.

The server speaks a tiny JSON/base64 protocol (documented in
``cli/serve.py``); this module wraps it so callers exchange numpy arrays
and classnames instead of hand-rolling payloads::

    from protoclip_tpu_torch.client import ServeClient
    client = ServeClient("http://gpu-host:8421")
    feats = client.encode(crops)                  # (N, d) float32
    names, probs = client.classify(crops)         # top-k per crop

Deliberately dependency-light — stdlib + numpy + PIL only, no torch — so
it imports on client machines that merely talk to a remote server (the
deployment shape of the reference's ROS consumers,
``toolkit/.../ros/proto_clip_node.py:31-121``, minus ROS).

Accepted image forms: HWC uint8 numpy arrays (PNG-encoded losslessly on
the wire), raw encoded bytes (JPEG/PNG passed through untouched), or
filesystem paths.
"""

from __future__ import annotations

import base64
import io
import json
import os
import urllib.error
import urllib.request
from typing import Iterable, List, Sequence, Tuple

import numpy as np


class ServeError(RuntimeError):
    """Server-reported failure; carries the HTTP status code."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message


def _to_b64(image) -> str:
    if isinstance(image, (bytes, bytearray)):
        raw = bytes(image)
    elif isinstance(image, (str, os.PathLike)):
        with open(image, "rb") as fh:
            raw = fh.read()
    else:
        from PIL import Image

        arr = np.asarray(image)
        if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
            raise ValueError(
                f"array images must be (H, W, 3) uint8, got {arr.shape} {arr.dtype}"
            )
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "PNG")  # lossless on the wire
        raw = buf.getvalue()
    return base64.b64encode(raw).decode()


class ServeClient:
    """Client for one server instance.

    ``timeout`` bounds each request; keep it generous for the very first
    request against a ``--no-warmup`` server.
    """

    def __init__(self, base_url: str = "http://127.0.0.1:8421",
                 timeout: float = 600.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = float(timeout)

    # -- low-level ------------------------------------------------------

    def _get_raw(self, path: str) -> bytes:
        try:
            with urllib.request.urlopen(
                self.base_url + path, timeout=self.timeout
            ) as resp:
                return resp.read()
        except urllib.error.HTTPError as err:
            raise ServeError(err.code, _err_message(err)) from None

    def _get(self, path: str) -> dict:
        return json.loads(self._get_raw(path))

    def _post(self, path: str, images: Iterable) -> dict:
        body = json.dumps({"images": [_to_b64(im) for im in images]}).encode()
        req = urllib.request.Request(
            self.base_url + path, data=body,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as err:
            raise ServeError(err.code, _err_message(err)) from None

    # -- API ------------------------------------------------------------

    def healthz(self) -> dict:
        """Server mode/manifest info (raises if unreachable/unhealthy)."""
        return self._get("/healthz")

    def statz(self) -> dict:
        """Per-route micro-batcher statistics (dispatches, fill, latency)."""
        return self._get("/statz")

    def metrics(self) -> str:
        """Prometheus text exposition of the serving metrics (``/metrics``)."""
        return self._get_raw("/metrics").decode()

    def encode(self, images: Sequence) -> np.ndarray:
        """Images -> (N, d) float32 CLIP features (``/encode`` route)."""
        out = self._post("/encode", images)
        return np.asarray(out["features"], np.float32)

    def classify(self, images: Sequence) -> Tuple[List[List[str]], np.ndarray]:
        """Images -> (top-k classnames per image, (N, k) float32 probs)."""
        out = self._post("/classify", images)
        return out["classnames"], np.asarray(out["scores"], np.float32)


def _err_message(err: urllib.error.HTTPError) -> str:
    try:
        return json.loads(err.read())["error"]
    except Exception:  # noqa: BLE001 — non-JSON error body
        return err.reason or "unknown error"
