"""Minimal HTTP serving front-end: images in, features or top-k classes out
(counterpart of ``protoclip_tpu/cli/serve.py``; the protocol is the same,
so the JAX package's ``ServeClient`` and a scrape config written for the
JAX server work against this one unchanged).

A dependency-free (stdlib ``http.server``) JSON/HTTP server over either
serving surface:

* ``--bundle DIR`` — encode mode: serve a serving bundle
  (``io/export.py``; on the card one CUDA graph per batch bucket, captured
  when the server starts); ``POST /encode`` returns (B, d) fp32 features.
* ``--mesh [N] --backbone NAME [--weights PATH]`` — encode mode over a live
  data-parallel encode: the weights copied to the first N devices (bare
  ``--mesh``: every card), a fixed global batch of ``--per-device-batch``
  rows per device sharded over them; ``POST /encode`` as above.
* ``--config cfg.yml --splits split.json [...checkpoint paths]`` —
  classify mode: serve a ``ProtoClipClassifier``
  (``toolkit/classifier.py``); ``POST /classify`` returns top-k class
  names + probabilities per image (the ROS results-node payload).

Protocol (JSON; images are base64-encoded JPEG/PNG bytes)::

    GET  /healthz              -> {"status": "ok", "mode": ..., ...};
                                  503 {"status": "degraded", ...} once a
                                  route's device dispatches fail 3x in a
                                  row (any success resets the streak)
    POST /encode   {"images": [b64, ...]}
                               -> {"features": [[f32...], ...]}
    POST /classify {"images": [b64, ...]}
                               -> {"classnames": [[...], ...],
                                   "scores": [[...], ...]}

    GET  /statz                -> micro-batcher dispatch statistics, and
                                  each route's span totals under "spans"
    GET  /metrics              -> the same + HTTP response counters in
                                  Prometheus text exposition format

Spans (``obs.profiler``, labelled with the route): ``serve.parse`` (the
body read and ``json.loads``; bytes), ``serve.decode`` (decode and
preprocess; images), ``serve.respond`` (``json.dumps`` and the write;
bytes), and the micro-batcher's ``batch.queue_wait`` and
``batch.dispatch``; one request id for the spans of one HTTP request.
Their totals are cumulative: difference them over a window.

Errors are JSON ``{"error": ...}``: 400 bad payload/negative length, 404
unknown route (lists available routes), 411 missing/unparseable
Content-Length, 413 body over 256 MB, 500 internal (surfaced, server
stays up).  Requests larger than the largest batch are split.

Threading model: HTTP handler threads do host work only (decode, bicubic
preprocess); each route's device work goes through its own
``MicroBatcher`` thread (``toolkit/microbatch.py``), which coalesces
concurrent requests into device batches and works on the route's device,
so N concurrent small requests cost one dispatch instead of N.  Coalescing
does not change a row (per-image independence; asserted in tests).
``--coalesce-ms`` sets the fill window (0 = dispatch whatever is queued,
never wait).  ``--device`` (default ``cuda``) is where the bundle and the
classifier run (``--device cpu`` with ``--mesh N`` gives N CPU shards).

    python -m protoclip_tpu_torch.cli.serve --bundle bundle/ --port 8421
    python -m protoclip_tpu_torch.cli.serve --mesh --backbone ViT-B/16 --port 8421
    python -m protoclip_tpu_torch.cli.serve --config configs/fewsol_198.yml \
        --splits splits/fewsol_splits_198.json --port 8421
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from protoclip_tpu_torch.obs import profiler


def _decode_images(payload: dict, draft_px: Optional[int] = None) -> list:
    """b64 JPEG/PNG list -> list of RGB PIL images.  ``draft_px`` opts into
    libjpeg's DCT-domain scaled decode (about 2x faster at camera sizes,
    JPEG only, not pixel-exact: the ``--fast-decode`` serving mode); other
    formats ignore it."""
    from PIL import Image

    images = payload.get("images")
    if not isinstance(images, list) or not images:
        raise ValueError('body must be {"images": [<b64 jpeg/png>, ...]}')
    out = []
    for i, b64 in enumerate(images):
        try:
            raw = base64.b64decode(b64, validate=True)
            im = Image.open(io.BytesIO(raw))
            if draft_px is not None:
                im.draft("RGB", (draft_px, draft_px))
            out.append(im.convert("RGB"))
        except Exception as exc:
            raise ValueError(f"images[{i}]: not decodable image bytes ({exc})")
    return out


def _make_pool():
    import concurrent.futures as futures

    return futures.ThreadPoolExecutor(max_workers=max(1, os.cpu_count() or 1))


def _preprocess_block(payload: dict, n_px: int, pool, fast_decode: bool):
    """Decode a request payload and resize-shorter + center-crop every
    image (the reference CLIP preprocess) into one ``(n, n_px, n_px, 3)``
    uint8 block, in parallel on ``pool`` (PIL and the native resize
    release the GIL).  Shared by the /encode and /classify routes so the
    preprocess cannot drift between them."""
    import numpy as np

    from protoclip_tpu_torch.data.transforms import clip_preprocess

    def prep(i_img):
        i, img = i_img
        block[i] = clip_preprocess(img, n_px)

    with profiler.span("serve.decode") as decode:
        imgs = _decode_images(payload, n_px if fast_decode else None)
        block = np.zeros((len(imgs), n_px, n_px, 3), np.uint8)
        list(pool.map(prep, enumerate(imgs)))
        decode.rows = len(imgs)
    return block


def make_mesh_encode_route(
    backbone: Optional[str] = None,
    weights: Optional[str] = None,
    mesh_devices: Optional[int] = None,
    per_device_batch: int = 32,
    warmup: bool = True,
    coalesce_ms: float = 5.0,
    fast_decode: bool = False,
    pool=None,
    clip=None,
    device=None,
) -> tuple:
    """(handler, info) for /encode over a live data-parallel encode.

    The bundle route runs on one device; a serving host may have several.
    This route runs the canonical serving encode (``io/export.py::
    make_encode_fn``) sharded over a 1-D mesh of the first ``mesh_devices``
    cards (``parallel.make_sharded_encode``; None: every card): the
    weights are copied to each card once, every card encodes its shard of a
    fixed global batch of ``per_device_batch`` rows per device, and the
    micro-batcher stays the one dispatch site.  The encode is row-local, so
    the rows equal the single-device encode's.  With ``device="cpu"`` the
    mesh is ``mesh_devices`` entries of the CPU.

    The W8A8 mode is read once, here: the route serves K3 if
    ``$PROTOCLIP_INT8`` is on now, and ``/healthz``'s ``int8`` says so
    (``int8_weights_prequantized``: the weights carry load-time int8
    layers).  ``clip=(cfg, params)`` injects a loaded model; otherwise
    ``models.clip.load_clip(backbone, weights)`` resolves the weights.
    """
    import numpy as np
    import torch

    from protoclip_tpu_torch.io.export import make_encode_fn
    from protoclip_tpu_torch.ops.kernels import int8_enabled
    from protoclip_tpu_torch.parallel import make_mesh, make_sharded_encode, replicated
    from protoclip_tpu_torch.toolkit.microbatch import MicroBatcher

    if per_device_batch < 1:
        raise ValueError(f"per_device_batch must be >= 1, got {per_device_batch}")
    if clip is None and not backbone:
        raise ValueError("mesh encode mode needs --backbone (or clip=)")
    device = torch.device("cuda" if device is None else device)
    mesh = make_mesh(mesh_devices, devices=None if device.type == "cuda" else
                     [device] * (mesh_devices or 1))
    if clip is not None:
        cfg, params = clip
    else:
        from protoclip_tpu_torch.models.clip import load_clip

        cfg, params = load_clip(backbone, weights, dtype=torch.bfloat16, device=mesh.device)
    batch = per_device_batch * mesh.size
    n_px = cfg.image_resolution
    int8 = int8_enabled()
    prequantized = any(isinstance(params.get(tower), dict) and "blocks_q" in params[tower]
                       for tower in ("visual", "text"))

    encode = make_sharded_encode(make_encode_fn(cfg, int8=int8), mesh)
    replicas = replicated(mesh).put(params)

    def run(block: np.ndarray) -> np.ndarray:
        return encode(replicas, block).cpu().numpy()

    if warmup:
        run(np.zeros((batch, n_px, n_px, 3), np.uint8))

    pool = pool if pool is not None else _make_pool()
    batcher = MicroBatcher(
        run, batch, (n_px, n_px, 3), np.uint8,
        max_wait_s=max(0.0, coalesce_ms) / 1e3,
        # one fixed global shape: every shard's batch stays the same
        trim_underfull=False, label="/encode",
    )

    def route(payload: dict) -> dict:
        block = _preprocess_block(payload, n_px, pool, fast_decode)
        return {"features": batcher.submit(block).tolist()}

    route.pool = pool
    route.batcher = batcher
    info = {
        "mode": "encode",
        "backbone": cfg.name,
        "mesh_devices": int(mesh.size),
        "per_device_batch": int(per_device_batch),
        "batch_size": int(batch),
        "image_resolution": int(n_px),
        "int8": bool(int8),
        "int8_weights_prequantized": bool(prequantized),
        "device": str(mesh.device),
        "coalesce_ms": max(0.0, coalesce_ms),
        "fast_decode": bool(fast_decode),
    }
    return route, info


def make_encode_route(
    bundle_dir: str, warmup: bool = True, coalesce_ms: float = 5.0,
    fast_decode: bool = False, pool=None, device=None,
) -> tuple:
    """(handler, info) for /encode over a serving bundle loaded onto
    ``device`` (default: the card, where loading captures one CUDA graph
    per bucket).  ``warmup`` runs one zero batch through every bucket
    before the server takes traffic (the JAX server's per-bucket warm-up,
    ``cli/serve.py:142-144``); on the card the load already ran one eager
    call and the capture of each bucket, so there is nothing left to warm."""
    import numpy as np

    from protoclip_tpu_torch.io.export import load_serving_bundle
    from protoclip_tpu_torch.toolkit.microbatch import MicroBatcher

    encode = load_serving_bundle(bundle_dir, device=device)
    batch = encode.manifest["batch_size"]
    n_px = encode.manifest["image_resolution"]
    buckets = [int(b) for b in encode.manifest.get("batch_sizes", [batch])]
    if warmup and encode.device.type != "cuda":
        for size in buckets:
            encode(np.zeros((size, n_px, n_px, 3), np.uint8))

    pool = pool if pool is not None else _make_pool()
    batcher = MicroBatcher(
        encode, batch, (n_px, n_px, 3), np.uint8,
        max_wait_s=max(0.0, coalesce_ms) / 1e3,
        # bucketed bundle: hand the batcher's underfull dispatches to the
        # smallest bucket instead of padding to the largest
        trim_underfull=len(buckets) > 1, label="/encode",
    )

    def route(payload: dict) -> dict:
        block = _preprocess_block(payload, n_px, pool, fast_decode)
        # one dispatch site for the whole route; over-batch requests are
        # split and concurrent requests coalesced inside the batcher
        return {"features": batcher.submit(block).tolist()}

    route.pool = pool  # shut down by the server's server_close()
    route.batcher = batcher
    route.encode = encode
    info = {
        "mode": "encode",
        "backbone": encode.manifest.get("backbone"),
        "batch_size": batch,
        "batch_sizes": buckets,
        "image_resolution": n_px,
        "int8": encode.manifest.get("int8"),
        "device": str(encode.device),
        "cuda_graphs": encode.device.type == "cuda",
        "coalesce_ms": max(0.0, coalesce_ms),
        "fast_decode": bool(fast_decode),
    }
    return route, info


def make_classify_route(
    classifier, warmup: bool = True, coalesce_ms: float = 5.0,
    fast_decode: bool = False, pool=None,
) -> tuple:
    """(handler, info) for /classify over a ``ProtoClipClassifier``.

    Same dispatch discipline as /encode: the preprocess is per-crop (rows
    independent), so concurrent requests' crops coalesce into one device
    batch via ``classifier.infer_canvases`` on the classifier's device;
    over-batch requests split across dispatches.  With ``batch_buckets`` an
    underfull window may run another bucket, whose products may round a
    probability in its last bits (top-k ids unchanged)."""
    import numpy as np

    from protoclip_tpu_torch.parallel.sharding import _on_device
    from protoclip_tpu_torch.toolkit.microbatch import MicroBatcher

    n_px = classifier.clip_cfg.image_resolution
    top_k = max(1, classifier.cfg.top_k)
    buckets = list(getattr(classifier, "batch_buckets", [classifier.max_batch]))
    device = getattr(classifier, "device", "cpu")
    if warmup:
        for size in buckets:
            classifier.infer_canvases(np.zeros((size, n_px, n_px, 3), np.uint8))

    pool = pool if pool is not None else _make_pool()

    def run_block(block: np.ndarray) -> np.ndarray:
        with _on_device(device):
            probs, idxs = classifier.infer_canvases(block)
        # pack (probs, ids) into one sliceable row block; class ids are
        # far below 2^24 so the float32 round trip is exact
        return np.concatenate(
            [probs.astype(np.float32), idxs.astype(np.float32)], axis=1
        )

    batcher = MicroBatcher(
        run_block, classifier.max_batch, (n_px, n_px, 3), np.uint8,
        max_wait_s=max(0.0, coalesce_ms) / 1e3,
        # bucketed classifier: infer_canvases pads trimmed underfull
        # dispatches to its smallest bucket
        trim_underfull=len(buckets) > 1, label="/classify",
    )

    def route(payload: dict) -> dict:
        block = _preprocess_block(payload, n_px, pool, fast_decode)
        packed = batcher.submit(block)
        probs, idxs = packed[:, :top_k], packed[:, top_k:].astype(np.int64)
        return {
            "classnames": classifier.names_for_ids(idxs),
            "scores": [[float(x) for x in row] for row in probs],
        }

    route.pool = pool
    route.batcher = batcher
    info = {
        "mode": "classify",
        "backbone": classifier.cfg.backbone,
        "top_k": top_k,  # the clamped width actually served, not raw cfg
        "num_classes": len(classifier.class_id_mapping),
        "batch_size": classifier.max_batch,
        "batch_sizes": buckets,
        "device": str(device),
        "coalesce_ms": max(0.0, coalesce_ms),
        "fast_decode": bool(fast_decode),
    }
    return route, info


_MAX_BODY = 256 << 20  # 256 MB request-body cap


_GET_PATHS = ("/healthz", "/statz", "/metrics")


def span_totals(route: str) -> dict:
    """``{span: {"count", "total_ms", "rows", "bytes"}}`` of the spans
    labelled ``route``, cumulative since the process started."""
    return {name: {"count": count, "total_ms": ns / 1e6, "rows": rows, "bytes": nbytes}
            for (name, label), (count, ns, rows, nbytes) in sorted(profiler.totals().items())
            if label == route}


def render_prometheus(routes: Dict[str, Callable], counters: Dict) -> str:
    """Prometheus text exposition (format 0.0.4) of the serving metrics:
    HTTP responses by route/status, and per-route micro-batcher dispatch
    counters, batch fill, and dispatch-latency quantiles (the JAX server's
    metric names), and each route's span totals (the port's own)."""
    lines = [
        "# HELP protoclip_http_responses_total HTTP responses by route and status code.",
        "# TYPE protoclip_http_responses_total counter",
    ]
    for (route, code), n in sorted(counters.items()):
        lines.append(
            f'protoclip_http_responses_total{{route="{route}",code="{code}"}} {n}'
        )
    batched = [
        (path, route.batcher.stats)
        for path, route in sorted(routes.items())
        if getattr(route, "batcher", None) is not None
    ]
    families = [
        ("protoclip_dispatches_total", "counter",
         "Device dispatches issued by the micro-batcher.", "dispatches"),
        ("protoclip_images_total", "counter",
         "Images processed across all dispatches.", "images"),
        ("protoclip_dispatch_failures_total", "counter",
         "Device dispatches that raised (requests got 500s).", "failures"),
        ("protoclip_consecutive_dispatch_failures", "gauge",
         "Current failure streak; >=3 degrades /healthz to 503.",
         "consecutive_failures"),
        ("protoclip_batch_fill_mean", "gauge",
         "Mean images per dispatch (device batch fill).", "mean_fill"),
        ("protoclip_batch_size", "gauge",
         "Device batch size.", "batch_size"),
    ]
    for name, typ, help_, key in families:
        lines += [f"# HELP {name} {help_}", f"# TYPE {name} {typ}"]
        for path, stats in batched:
            lines.append(f'{name}{{route="{path}"}} {stats[key]}')
    lines += [
        "# HELP protoclip_dispatch_latency_ms Dispatch latency quantiles "
        "over the last <=256 dispatches.",
        "# TYPE protoclip_dispatch_latency_ms gauge",
    ]
    for path, stats in batched:
        for quantile, key in (("0.5", "dispatch_ms_p50"),
                              ("0.99", "dispatch_ms_p99"),
                              ("1.0", "dispatch_ms_max")):
            if key in stats:
                lines.append(
                    f'protoclip_dispatch_latency_ms{{route="{path}",'
                    f'quantile="{quantile}"}} {stats[key]}'
                )
    spans = {path: span_totals(path) for path, _ in batched}
    for name, help_, value in (
            ("protoclip_span_seconds_total", "Seconds in each span of a route.",
             lambda t: t["total_ms"] / 1e3),
            ("protoclip_spans_total", "Spans closed, by route and span.",
             lambda t: t["count"])):
        lines += [f"# HELP {name} {help_}", f"# TYPE {name} counter"]
        for path, by_span in spans.items():
            for span_name, total in by_span.items():
                lines.append(f'{name}{{route="{path}",span="{span_name}"}} {value(total)}')
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    routes: Dict[str, Callable[[dict], dict]] = {}
    info: dict = {}
    quiet = False
    # per-server (the build_server subclass rebinds these): (route, code)
    # response counters feeding /metrics
    counters: Dict = {}
    counters_lock = threading.Lock()
    # socket timeout: a stalled client (short body, held connection) must
    # not pin its handler thread forever
    timeout = 120

    def _count(self, code: int) -> None:
        # bound label cardinality: arbitrary request paths are bucketed
        label = (
            self.path
            if self.path in self.routes or self.path in _GET_PATHS
            else "other"
        )
        with self.counters_lock:
            key = (label, code)
            self.counters[key] = self.counters.get(key, 0) + 1

    def _send(self, code: int, obj: dict) -> int:
        """Send ``obj`` as JSON; returns the body's length."""
        self._count(code)
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        return len(body)

    def _respond(self, code: int, obj: dict) -> None:
        """:meth:`_send` as the request's ``serve.respond`` span."""
        with profiler.span("serve.respond") as respond:
            respond.nbytes = self._send(code, obj)

    def _send_text(self, code: int, text: str) -> None:
        self._count(code)
        body = text.encode()
        self.send_response(code)
        self.send_header(
            "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
        )
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    # consecutive failed device dispatches on any route before /healthz
    # reports degraded (HTTP 503 -> load balancers pull the host); any
    # successful dispatch resets the streak
    unhealthy_after = 3
    # min seconds between device probes from degraded /healthz checks
    probe_interval_s = 10.0
    # longest a single /healthz request may wait on a recovery probe; a
    # probe outliving this keeps running in the background and later
    # health checks return 503 immediately (in-flight guard below)
    probe_join_s = 1.0
    # id(batcher) -> probe thread in flight; guarded by _probes_lock.  The
    # probe dispatch has no deadline (MicroBatcher.submit blocks until the
    # device answers), so it must not run unbounded inline in the health
    # check: a hung (non-erroring) device would stall one /healthz request
    # per probe window forever instead of returning a fast 503.
    _probes_in_flight: Dict[int, threading.Thread] = {}
    _probes_lock = threading.Lock()

    def _spawn_probe(self, batcher) -> None:
        """Run one recovery probe per batcher in a background thread and
        wait at most ``probe_join_s`` for it: an instantly-succeeding probe
        flips the current health check back to 200 (self-recovery without
        POST traffic), while a hung device costs one bounded wait — every
        later /healthz sees the probe still in flight and 503s at once."""
        key = id(batcher)
        with self._probes_lock:
            prev = self._probes_in_flight.get(key)
            if prev is not None and prev.is_alive():
                return  # hung/slow probe already running: fast 503

            def _probe() -> None:
                try:
                    batcher.health_probe(self.probe_interval_s)
                finally:
                    with self._probes_lock:
                        self._probes_in_flight.pop(key, None)

            t = threading.Thread(target=_probe, daemon=True, name="healthz-probe")
            self._probes_in_flight[key] = t
            t.start()
        t.join(self.probe_join_s)

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        if self.path == "/healthz":
            degraded = {}
            for path, route in self.routes.items():
                batcher = getattr(route, "batcher", None)
                if batcher is None:
                    continue
                if batcher.stats["consecutive_failures"] >= self.unhealthy_after:
                    # a pulled replica only receives health checks: probe
                    # the device (rate-limited, in the background) so
                    # recovery is reachable without POST traffic, then
                    # re-read the streak (an instant probe success flips
                    # this very health check back to 200)
                    self._spawn_probe(batcher)
                stats = batcher.stats
                if stats["consecutive_failures"] >= self.unhealthy_after:
                    degraded[path] = {
                        "consecutive_failures": stats["consecutive_failures"],
                        "last_error": stats.get("last_error", ""),
                    }
            if degraded:
                self._send(503, {"status": "degraded", "routes": degraded,
                                 **self.info})
            else:
                self._send(200, {"status": "ok", **self.info})
        elif self.path == "/statz":
            stats = {
                path: dict(route.batcher.stats, spans=span_totals(path))
                for path, route in self.routes.items()
                if getattr(route, "batcher", None) is not None
            }
            self._send(200, stats)
        elif self.path == "/metrics":
            with self.counters_lock:
                counters = dict(self.counters)
            self._send_text(200, render_prometheus(self.routes, counters))
        else:
            self._send(404, {"error": f"no route {self.path}"})

    def do_POST(self) -> None:  # noqa: N802
        route = self.routes.get(self.path)
        if route is None:
            self._send(404, {"error": f"no route {self.path}",
                             "routes": sorted(self.routes)})
            return
        with profiler.request(self.path):
            self._post(route)

    def _post(self, route: Callable[[dict], dict]) -> None:
        try:
            try:
                length = int(self.headers.get("Content-Length", ""))
            except ValueError:
                self._respond(411, {"error": "Content-Length required"})
                return
            if length < 0:
                self._respond(400, {"error": "negative Content-Length"})
                return
            if length > _MAX_BODY:
                self._respond(413, {"error": f"body exceeds {_MAX_BODY} bytes"})
                return
            with profiler.span("serve.parse", nbytes=length):
                payload = json.loads(self.rfile.read(length) or b"{}")
            self._respond(200, route(payload))
        except ValueError as exc:
            self._respond(400, {"error": str(exc)})
        except Exception as exc:  # noqa: BLE001 — surface, don't crash the server
            self._respond(500, {"error": f"{type(exc).__name__}: {exc}"})

    def log_message(self, fmt: str, *args) -> None:
        if not self.quiet:
            sys.stderr.write(
                "[serve] %s %s\n" % (self.address_string(), fmt % args)
            )


def build_server(
    host: str = "127.0.0.1",
    port: int = 8421,
    bundle: Optional[str] = None,
    classifier=None,
    quiet: bool = False,
    warmup: bool = True,
    coalesce_ms: float = 5.0,
    fast_decode: bool = False,
    device=None,
    mesh_devices: Optional[int] = None,
    backbone: Optional[str] = None,
    weights: Optional[str] = None,
    per_device_batch: int = 32,
    clip=None,
) -> ThreadingHTTPServer:
    """Construct (not start) the server; ``port=0`` picks a free port.
    /encode serves exactly one of ``bundle``, loaded onto ``device``
    (default: the card), or the mesh mode (``mesh_devices``/``backbone``/
    ``clip``: :func:`make_mesh_encode_route`); /classify serves
    ``classifier`` on its own device."""
    mesh_mode = mesh_devices is not None or clip is not None or backbone is not None
    if bundle is not None and mesh_mode:
        raise ValueError("--bundle and mesh encode mode both serve /encode; pick one")
    routes, infos = {}, {}
    # one preprocess pool for the whole server: per-route pools would
    # oversubscribe the host with 2x cpu_count threads in dual mode
    pool = _make_pool()
    if bundle is not None:
        routes["/encode"], infos["encode"] = make_encode_route(
            bundle, warmup=warmup, coalesce_ms=coalesce_ms,
            fast_decode=fast_decode, pool=pool, device=device,
        )
    elif mesh_mode:
        routes["/encode"], infos["encode"] = make_mesh_encode_route(
            backbone=backbone, weights=weights, mesh_devices=mesh_devices,
            per_device_batch=per_device_batch, warmup=warmup, coalesce_ms=coalesce_ms,
            fast_decode=fast_decode, pool=pool, clip=clip, device=device,
        )
    if classifier is not None:
        routes["/classify"], infos["classify"] = make_classify_route(
            classifier, warmup=warmup, coalesce_ms=coalesce_ms,
            fast_decode=fast_decode, pool=pool,
        )
    if not routes:
        pool.shutdown(wait=False)
        raise ValueError("provide a bundle and/or a classifier")
    if len(infos) == 1:
        info = next(iter(infos.values()))
    else:  # dual mode: keep both routes' info visible in /healthz
        info = {"mode": "+".join(sorted(infos))}
        for mode, sub in infos.items():
            info[mode] = {k: v for k, v in sub.items() if k != "mode"}

    handler = type("Handler", (_Handler,), {
        "routes": routes, "info": info, "quiet": quiet,
        # fresh per-server counters: the base-class dict would be shared
        # (and accumulate) across every server built in this process
        "counters": {}, "counters_lock": threading.Lock(),
    })
    pools = list({  # dedupe: routes share the server-wide pool
        id(p): p
        for p in (getattr(r, "pool", None) for r in routes.values())
        if p
    }.values())
    batchers = [
        b for b in (getattr(r, "batcher", None) for r in routes.values()) if b
    ]

    class _Server(ThreadingHTTPServer):
        # socketserver's default listen backlog is 5: a burst of concurrent
        # clients (the very load micro-batching exists for) gets connection
        # resets at the kernel before a handler thread ever runs
        request_queue_size = 128
        # how long server_close() waits for in-flight POST handlers before
        # closing the micro-batchers (a wedged client must not hang shutdown;
        # its handler thread is daemonic and dies with the process)
        close_grace_s = 10.0

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._inflight = 0
            self._inflight_cv = threading.Condition()

        def _track_inflight(self, delta: int) -> None:
            with self._inflight_cv:
                self._inflight += delta
                if self._inflight == 0:
                    self._inflight_cv.notify_all()

        # In-flight accounting must start at accept time, in the
        # serve_forever thread, before the handler thread is spawned:
        # counting inside do_POST leaves a window (thread spawn, request
        # line/header parse — client-controlled, up to the handler timeout)
        # where an accepted request is invisible to server_close's wait and
        # would still hit a closed micro-batcher.  Connections are HTTP/1.0
        # (no keep-alive), so one accept == one request and an idle
        # persistent connection can never pin the count.
        def process_request(self, request, client_address):
            self._track_inflight(1)
            try:
                super().process_request(request, client_address)
            except BaseException:
                # the handler thread never spawned; undo here (on success
                # the spawned thread's finally below decrements)
                self._track_inflight(-1)
                raise

        def process_request_thread(self, request, client_address):
            try:
                super().process_request_thread(request, client_address)
            finally:
                self._track_inflight(-1)

        def server_close(self):  # reap route workers with the server
            super().server_close()
            # handler threads are daemonic, so the super() call above did not
            # join them; wait (bounded) for in-flight requests to finish
            # before closing their batchers, or a request between accept and
            # batcher.submit() would fail with "MicroBatcher is closed"
            deadline = time.monotonic() + self.close_grace_s
            with self._inflight_cv:
                while self._inflight > 0:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._inflight_cv.wait(remaining)
            for batcher in batchers:
                batcher.close()
            for pool in pools:
                pool.shutdown(wait=False)

    return _Server((host, port), handler)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8421)
    parser.add_argument("--bundle", help="serving bundle dir (/encode)")
    parser.add_argument(
        "--mesh", type=int, nargs="?", const=0, default=None, metavar="N",
        help="mesh encode mode (/encode): live data-parallel encode over the first N "
        "devices (bare --mesh = every card); needs --backbone; mutually exclusive with "
        "--bundle; int8 via $PROTOCLIP_INT8",
    )
    parser.add_argument("--backbone", help="CLIP backbone for --mesh (e.g. 'ViT-B/16'); "
                        "weights resolve via --weights / $PROTOCLIP_WEIGHTS_DIR")
    parser.add_argument("--weights", help="explicit weights path for --mesh")
    parser.add_argument("--per-device-batch", type=int, default=32,
                        help="mesh mode: batch rows per device (global batch = N x this)")
    parser.add_argument("--config", help="experiment YAML (/classify)")
    parser.add_argument("--splits", help="split JSON for the id->name map")
    parser.add_argument("--memory_bank_v")
    parser.add_argument("--memory_bank_t")
    parser.add_argument("--adapter_weights")
    parser.add_argument(
        "--classify-buckets", type=int, nargs="*", default=None,
        help="extra batch sizes for /classify (e.g. 2 8): underfull "
        "dispatches pad to the smallest bucket that fits instead of the "
        "classifier's max batch (encode-mode buckets come from the bundle)",
    )
    parser.add_argument(
        "--no-warmup", action="store_true",
        help="skip the startup zero batch through every bucket",
    )
    parser.add_argument(
        "--coalesce-ms", type=float, default=5.0,
        help="micro-batch fill window: after a request arrives, wait up to "
        "this long for concurrent requests to share its device dispatch "
        "(0 = never wait; dispatch whatever is queued)",
    )
    parser.add_argument(
        "--fast-decode", action="store_true",
        help="libjpeg DCT-scaled decode for JPEG payloads (~2x host decode "
        "at camera sizes; not pixel-exact with full decode)",
    )
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (default: the card)")
    return parser


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    mesh_mode = args.mesh is not None
    if not args.bundle and not mesh_mode and not args.config:
        parser.error("provide --bundle or --mesh (encode mode) and/or --config (classify mode)")
    if mesh_mode and args.bundle:
        parser.error("--bundle and --mesh both serve /encode; pick one")
    if mesh_mode and not args.backbone:
        parser.error("--mesh needs --backbone")

    classifier = None
    if args.config:
        from protoclip_tpu_torch.core.config import load_config
        from protoclip_tpu_torch.toolkit.classifier import ProtoClipClassifier

        classifier = ProtoClipClassifier(
            load_config(args.config),
            splits_path=args.splits,
            memory_bank_v_path=args.memory_bank_v,
            memory_bank_t_path=args.memory_bank_t,
            adapter_weights_path=args.adapter_weights,
            batch_buckets=args.classify_buckets,
            device=args.device,
        )

    server = build_server(
        args.host, args.port, bundle=args.bundle, classifier=classifier,
        warmup=not args.no_warmup, coalesce_ms=args.coalesce_ms,
        fast_decode=args.fast_decode, device=args.device,
        mesh_devices=(args.mesh or None) if mesh_mode else None,
        backbone=args.backbone if mesh_mode else None,
        weights=args.weights, per_device_batch=args.per_device_batch,
    )
    host, port = server.server_address[:2]
    routes = sorted(server.RequestHandlerClass.routes)
    print(f"[serve] listening on http://{host}:{port} routes={routes}",
          file=sys.stderr)

    # graceful stop on SIGTERM (the supervisor/container default): finish
    # in-flight requests, flush the micro-batcher, release the device
    import signal

    def _term(signum, frame):
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
