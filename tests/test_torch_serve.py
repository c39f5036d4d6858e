"""The port's HTTP serving front-end (``protoclip_tpu_torch/cli/serve.py``)
and client on the CPU (``device="cpu"``: each bundle bucket is the eager
encode), with the non-mesh cases of ``tests/test_serve.py`` and of the
classify route in ``tests/test_toolkit.py``, and against the JAX server:
the same fp32 JAX bundle served by both within 1e-5, JAX's ``ServeClient``
against the port's server, the same ``/metrics`` families, and /classify
on the port's classifier against JAX's route on JAX's (fp32: equal names,
probabilities within 1e-5)."""

import base64
import http.client
import io
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from protoclip_tpu.cli.serve import build_server as jax_build_server
from protoclip_tpu.cli.serve import make_classify_route as jax_make_classify_route
from protoclip_tpu.client import ServeClient as JaxServeClient
from protoclip_tpu.client import ServeError as JaxServeError
from protoclip_tpu.io.export import save_serving_bundle as jax_save
from protoclip_tpu.models.clip import init_clip_params as jax_init_clip_params
from protoclip_tpu.toolkit.classifier import ProtoClipClassifier as JaxClassifier

from protoclip_tpu_torch.cli.serve import build_server, make_classify_route
from protoclip_tpu_torch.client import ServeClient, ServeError
from protoclip_tpu_torch.data.transforms import clip_preprocess
from protoclip_tpu_torch.io.export import load_serving_bundle, save_serving_bundle
from protoclip_tpu_torch.models import clip
from protoclip_tpu_torch.toolkit.classifier import ProtoClipClassifier
from tests.conftest import prometheus_value
from tests.test_models import TINY_VIT
from tests.test_serve import _b64_jpeg, _post
from tests.test_toolkit import classifier_env  # noqa: F401  (pytest fixture)
from tests.test_torch_models import port_config
from tests.test_torch_toolkit import _configs, _triple

CFG = port_config(TINY_VIT)


def _start(srv):
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return thread


def _stop(srv, thread):
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=5)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


@pytest.fixture(scope="module")
def jax_bundle(tmp_path_factory):
    """A JAX-written fp32 bundle of the tiny ViT, batch 4."""
    path = str(tmp_path_factory.mktemp("srv") / "bundle")
    jax_save(path, TINY_VIT, jax_init_clip_params(jax.random.PRNGKey(0), TINY_VIT),
             batch_size=4)
    return path


@pytest.fixture(scope="module")
def server(jax_bundle):
    """The port's server over the JAX bundle, on the CPU."""
    srv = build_server(port=0, bundle=jax_bundle, quiet=True, device="cpu")
    thread = _start(srv)
    yield srv, jax_bundle
    _stop(srv, thread)


@pytest.fixture(scope="module")
def port_bundle(tmp_path_factory):
    """A port-written bf16 bundle of the tiny ViT, batch 8, buckets 2 and 4."""
    params = clip.cast_params(clip.init_clip_params(np.random.default_rng(3), CFG),
                              torch.bfloat16)
    path = str(tmp_path_factory.mktemp("srv") / "port_bundle")
    save_serving_bundle(path, CFG, params, batch_size=8, batch_sizes=(2, 4))
    return path


def _arrays(seed, n, base=(40, 37)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (base[0] + i, base[1] + i, 3)).astype(np.uint8)
            for i in range(n)]


def _block(arrays, n_px=32):
    """The server's preprocess of PNG payloads, done directly."""
    block = np.zeros((len(arrays), n_px, n_px, 3), np.uint8)
    for i, a in enumerate(arrays):
        im = Image.open(io.BytesIO(base64.b64decode(_b64_jpeg(a)))).convert("RGB")
        block[i] = clip_preprocess(im, n_px)
    return block


def test_healthz_and_routes(server):
    srv, _ = server
    port = srv.server_address[1]
    status, raw = _get(port, "/healthz")
    health = json.loads(raw)
    assert status == 200 and health["status"] == "ok"
    assert health["mode"] == "encode" and health["backbone"] == "tiny-vit"
    assert health["device"] == "cpu" and health["cuda_graphs"] is False
    status, body = _post(port, "/nope", {})
    assert status == 404 and "/encode" in body["routes"]
    status, raw = _get(port, "/nope")
    assert status == 404


def test_encode_route_matches_direct_bundle_call_and_the_jax_server(server):
    """Six images over batch 4 (the split), odd sizes (the preprocess):
    every row equals a direct call of the port's bundle loader, and the JAX
    server on the same bundle within 1e-5."""
    srv, bundle = server
    arrs = _arrays(0, 6)
    payload = {"images": [_b64_jpeg(a) for a in arrs]}
    status, body = _post(srv.server_address[1], "/encode", payload)
    assert status == 200
    feats = np.asarray(body["features"], np.float32)
    assert feats.shape == (6, 32)
    encode = load_serving_bundle(bundle, device="cpu")
    block = _block(arrs)
    np.testing.assert_array_equal(feats[:4], encode(block[:4]))
    np.testing.assert_array_equal(feats[4:], encode(block[4:]))

    jsrv = jax_build_server(port=0, bundle=bundle, quiet=True)
    thread = _start(jsrv)
    try:
        status, jbody = _post(jsrv.server_address[1], "/encode", payload)
    finally:
        _stop(jsrv, thread)
    assert status == 200
    np.testing.assert_allclose(feats, np.asarray(jbody["features"], np.float32),
                               atol=1e-5, rtol=0)


def test_encode_route_rejects_bad_payloads(server):
    port = server[0].server_address[1]
    status, body = _post(port, "/encode", {})
    assert status == 400 and "images" in body["error"]
    status, body = _post(port, "/encode", {"images": ["!!not-b64!!"]})
    assert status == 400 and "images[0]" in body["error"]


def test_content_length_protocol(server):
    port = server[0].server_address[1]

    def raw_post(headers, body=b""):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        try:
            conn.putrequest("POST", "/encode", skip_accept_encoding=True)
            for k, v in headers.items():
                conn.putheader(k, v)
            conn.endheaders()
            if body:
                conn.send(body)
            return conn.getresponse().status
        finally:
            conn.close()

    assert raw_post({}) == 411
    assert raw_post({"Content-Length": "abc"}) == 411
    assert raw_post({"Content-Length": "-1"}) == 400
    assert raw_post({"Content-Length": str(300 << 20)}) == 413  # over the 256 MB cap
    assert _get(port, "/healthz")[0] == 200


def test_internal_error_returns_500_and_server_survives(server):
    srv, _ = server

    def boom(payload):
        raise RuntimeError("kaboom")

    srv.RequestHandlerClass.routes["/boom"] = boom
    try:
        status, body = _post(srv.server_address[1], "/boom", {})
        assert status == 500 and "RuntimeError" in body["error"]
        assert _get(srv.server_address[1], "/healthz")[0] == 200
    finally:
        del srv.RequestHandlerClass.routes["/boom"]


def test_short_body_times_out_instead_of_wedging(server):
    srv, _ = server
    port = srv.server_address[1]
    handler = srv.RequestHandlerClass
    old_timeout = handler.timeout
    handler.timeout = 1
    try:
        sock = socket.create_connection(("127.0.0.1", port), timeout=10)
        sock.sendall(b"POST /encode HTTP/1.1\r\nHost: x\r\nContent-Length: 1000\r\n\r\nshort")
        t0 = time.monotonic()
        while sock.recv(4096):  # the server gives up on the body and closes
            pass
        assert time.monotonic() - t0 < 5
        assert _get(port, "/healthz")[0] == 200
        sock.close()
    finally:
        handler.timeout = old_timeout


def test_bucketed_port_bundle_serving_matches_full_batch(port_bundle):
    srv = build_server(port=0, bundle=port_bundle, quiet=True, coalesce_ms=0.0, device="cpu")
    thread = _start(srv)
    try:
        port = srv.server_address[1]
        health = json.loads(_get(port, "/healthz")[1])
        assert health["batch_sizes"] == [2, 4, 8]
        assert srv.RequestHandlerClass.routes["/encode"].batcher.trim_underfull
        arrs = _arrays(7, 2, base=(40, 37))
        status, body = _post(port, "/encode", {"images": [_b64_jpeg(a) for a in arrs]})
        assert status == 200
        encode = load_serving_bundle(port_bundle, device="cpu")
        np.testing.assert_array_equal(np.asarray(body["features"], np.float32),
                                      encode(_block(arrs)))
    finally:
        _stop(srv, thread)


class FakeClassifier:  # just enough surface for the route builder
    class cfg:
        backbone = "tiny"
        top_k = 2

    class clip_cfg:
        image_resolution = 8

    class_id_mapping = {0: "a", 1: "b"}
    max_batch = 4
    device = torch.device("cpu")

    def infer_canvases(self, canvases):
        raise AssertionError("not dispatched in this construction-only test")


def test_dual_mode_healthz_reports_both_routes(jax_bundle):
    srv = build_server(port=0, bundle=jax_bundle, classifier=FakeClassifier(), quiet=True,
                       warmup=False, device="cpu")
    try:
        info = srv.RequestHandlerClass.info
        assert info["mode"] == "classify+encode"
        assert info["encode"]["backbone"] == "tiny-vit"
        assert info["encode"]["batch_size"] == 4
        assert info["classify"]["num_classes"] == 2
        assert set(srv.RequestHandlerClass.routes) == {"/encode", "/classify"}
    finally:
        srv.server_close()
    with pytest.raises(ValueError, match="provide a bundle"):
        build_server(port=0, device="cpu")


def test_concurrent_encode_requests_coalesce_and_stay_bitidentical(server):
    """Concurrent 1-image requests share dispatches and get exactly the rows
    they get when posted one at a time."""
    srv = build_server(port=0, bundle=server[1], quiet=True, coalesce_ms=250.0, device="cpu")
    thread = _start(srv)
    try:
        port = srv.server_address[1]
        arrs = [np.random.default_rng(7).integers(0, 256, (36 + i, 41 - i, 3)).astype(np.uint8)
                for i in range(4)]
        payloads = [{"images": [_b64_jpeg(a)]} for a in arrs]
        serial = []
        for p in payloads:
            status, body = _post(port, "/encode", p)
            assert status == 200
            serial.append(np.asarray(body["features"], np.float32))
        before = json.loads(_get(port, "/statz")[1])["/encode"]
        assert before["dispatches"] == len(payloads)
        barrier = threading.Barrier(len(payloads))
        results = [None] * len(payloads)

        def worker(i):
            barrier.wait()
            results[i] = _post(port, "/encode", payloads[i])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(payloads))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        for i, (status, body) in enumerate(results):
            assert status == 200
            np.testing.assert_array_equal(np.asarray(body["features"], np.float32), serial[i])
        after = json.loads(_get(port, "/statz")[1])["/encode"]
        assert after["images"] - before["images"] == len(payloads)
        assert after["dispatches"] - before["dispatches"] < len(payloads)
    finally:
        _stop(srv, thread)


@pytest.mark.parametrize("client_cls", [ServeClient, JaxServeClient], ids=["port", "jax"])
def test_serve_client_encode_and_errors(server, client_cls):
    """Either package's ServeClient against the port's server: healthz,
    statz, metrics, array/bytes image forms, and the errors as ServeError."""
    srv, _ = server
    client = client_cls(f"http://127.0.0.1:{srv.server_address[1]}")
    assert client.healthz()["status"] == "ok"
    arr = np.random.default_rng(13).integers(0, 256, (40, 30, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    feats = client.encode([arr, buf.getvalue()])
    _, raw = _post(srv.server_address[1], "/encode", {"images": [_b64_jpeg(arr)]})
    want = np.asarray(raw["features"], np.float32)
    np.testing.assert_array_equal(feats[0], want[0])
    np.testing.assert_array_equal(feats[1], want[0])
    assert client.statz()["/encode"]["dispatches"] > 0
    assert "protoclip_dispatches_total" in client.metrics()
    errors = (ServeError, JaxServeError)
    with pytest.raises(errors, match="not decodable"):
        client.encode([b"junk-bytes"])
    with pytest.raises(errors) as exc_info:
        client._post("/nope", [arr])
    assert exc_info.value.status == 404
    with pytest.raises(ValueError, match="uint8"):
        client.encode([arr.astype(np.float32)])


def test_client_imports_only_stdlib_numpy_and_pil():
    import ast

    import protoclip_tpu_torch.client as client_mod

    with open(client_mod.__file__) as fh:
        tree = ast.parse(fh.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "torch", "protoclip_tpu", "protoclip_tpu_torch"}, roots
    assert roots <= {"__future__", "base64", "io", "json", "os", "urllib", "typing", "numpy",
                     "PIL"}, roots


def test_fast_decode_mode_serves_jpegs(server):
    srv = build_server(port=0, bundle=server[1], quiet=True, fast_decode=True, device="cpu")
    thread = _start(srv)
    try:
        port = srv.server_address[1]
        assert json.loads(_get(port, "/healthz")[1])["fast_decode"] is True
        arr = np.random.default_rng(11).integers(0, 256, (300, 400, 3)).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "JPEG", quality=90)
        status, body = _post(port, "/encode", {
            "images": [base64.b64encode(buf.getvalue()).decode(), _b64_jpeg(arr)]})
        assert status == 200
        feats = np.asarray(body["features"], np.float32)
        assert feats.shape[0] == 2 and np.isfinite(feats).all()
        cos = feats[0] @ feats[1] / (np.linalg.norm(feats[0]) * np.linalg.norm(feats[1]))
        assert cos > 0.9
    finally:
        _stop(srv, thread)


def test_server_close_waits_for_inflight_handlers(server):
    srv = build_server(port=0, bundle=server[1], quiet=True, coalesce_ms=0.0, device="cpu")
    handler = srv.RequestHandlerClass
    entered, release = threading.Event(), threading.Event()
    real_route = handler.routes["/encode"]

    def gated(payload):
        entered.set()
        assert release.wait(timeout=30)
        return real_route(payload)

    gated.batcher = real_route.batcher
    handler.routes = dict(handler.routes, **{"/encode": gated})
    serve_thread = _start(srv)
    port = srv.server_address[1]
    result = {}
    client_thread = threading.Thread(target=lambda: result.update(resp=_post(
        port, "/encode", {"images": [_b64_jpeg(np.zeros((32, 32, 3), np.uint8))]})), daemon=True)
    client_thread.start()
    assert entered.wait(timeout=30)
    closer = threading.Thread(target=lambda: (srv.shutdown(), srv.server_close()), daemon=True)
    closer.start()
    time.sleep(0.2)
    release.set()
    for t in (closer, client_thread, serve_thread):
        t.join(timeout=30)
        assert not t.is_alive()
    status, body = result["resp"]
    assert status == 200 and "features" in body


def test_server_close_waits_for_accepted_but_unparsed_request(server):
    srv = build_server(port=0, bundle=server[1], quiet=True, coalesce_ms=0.0, device="cpu")
    serve_thread = _start(srv)
    port = srv.server_address[1]
    body = json.dumps({"images": [_b64_jpeg(np.zeros((32, 32, 3), np.uint8))]}).encode()
    head = (f"POST /encode HTTP/1.1\r\nHost: x\r\nContent-Type: application/json"
            f"\r\nContent-Length: {len(body)}\r\n\r\n").encode()
    sock = socket.create_connection(("127.0.0.1", port), timeout=30)
    try:
        sock.sendall(head[:7])
        deadline = time.monotonic() + 30
        while srv._inflight < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert srv._inflight >= 1
        closer = threading.Thread(target=lambda: (srv.shutdown(), srv.server_close()),
                                  daemon=True)
        closer.start()
        time.sleep(0.2)
        sock.sendall(head[7:] + body)
        resp = b""
        while b"\r\n\r\n" not in resp:
            chunk = sock.recv(65536)
            if not chunk:
                break
            resp += chunk
        closer.join(timeout=30)
        serve_thread.join(timeout=30)
        assert int(resp.split(b" ", 2)[1]) == 200
    finally:
        sock.close()


def test_cli_sigterm_graceful_shutdown_and_mesh_exit(server, capsys):
    """``python -m protoclip_tpu_torch.cli.serve --device cpu`` answers and
    exits 0 on SIGTERM; ``--bundle`` with ``--mesh`` exits with the JAX
    CLI's "pick one" refusal, and ``--mesh`` without ``--backbone`` too."""
    from protoclip_tpu_torch.cli.serve import main

    for argv, message in ((["--bundle", server[1], "--mesh", "2"], "pick one"),
                          (["--mesh", "2"], "--mesh needs --backbone")):
        with pytest.raises(SystemExit):
            main(argv)
        assert message in capsys.readouterr().err
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "protoclip_tpu_torch.cli.serve", "--bundle", server[1],
         "--port", str(port), "--device", "cpu"],
        env=env, stderr=subprocess.DEVNULL, cwd=os.path.dirname(os.path.dirname(__file__)),
    )
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2) as r:
                    assert json.loads(r.read())["status"] == "ok"
                    break
            except (urllib.error.URLError, ConnectionError):
                time.sleep(0.3)
        else:
            pytest.fail("server never became healthy")
        assert ServeClient(f"http://127.0.0.1:{port}").encode(
            [np.zeros((32, 32, 3), np.uint8)]).shape == (1, 32)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_default_device_is_the_card(jax_bundle):
    from protoclip_tpu_torch.cli.serve import build_parser

    assert build_parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("the card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_server(port=0, bundle=jax_bundle, quiet=True)


def test_connection_burst_is_not_reset(server):
    srv, _ = server
    assert type(srv).request_queue_size >= 64
    port = srv.server_address[1]
    n = 48
    payload = {"images": [_b64_jpeg(np.zeros((24, 24, 3), np.uint8))]}
    statuses = [None] * n
    barrier = threading.Barrier(n)

    def worker(i):
        barrier.wait()
        statuses[i], _ = _post(port, "/encode", payload)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert statuses == [200] * n


def _families(text):
    return sorted(line.split()[2] for line in text.splitlines() if line.startswith("# TYPE"))


SPAN_FAMILIES = ["protoclip_span_seconds_total", "protoclip_spans_total"]
SERVER_SPANS = ("serve.parse", "serve.decode", "batch.queue_wait", "batch.dispatch",
                "serve.respond")


def test_statz_and_metrics_expose_the_route_spans(server):
    """/statz's "spans" of /encode count one parse, decode, queue wait and
    reply a request and one dispatch a dispatch; /metrics' span families
    agree with it; every key /statz had is still there."""
    srv, _ = server
    port = srv.server_address[1]
    batcher = srv.RequestHandlerClass.routes["/encode"].batcher
    before = json.loads(_get(port, "/statz")[1])["/encode"]
    requests = 3
    for i in range(requests):
        arr = np.random.default_rng(40 + i).integers(0, 256, (30 + i, 40, 3)).astype(np.uint8)
        assert _post(port, "/encode", {"images": [_b64_jpeg(arr)] * (i + 1)})[0] == 200

    def grew(name, key="count"):
        return spans.get(name, {}).get(key, 0) - before["spans"].get(name, {}).get(key, 0)

    deadline = time.monotonic() + 30
    while True:  # a reply's span closes after the client has read it
        after = json.loads(_get(port, "/statz")[1])["/encode"]
        spans = after["spans"]
        if grew("serve.respond") == requests or time.monotonic() > deadline:
            break
        time.sleep(0.01)
    text = _get(port, "/metrics")[1].decode()
    assert set(after) == set(batcher.stats) | {"spans"}
    assert set(SERVER_SPANS) <= set(spans)

    for name in ("serve.parse", "serve.decode", "batch.queue_wait", "serve.respond"):
        assert grew(name) == requests, name
    assert grew("batch.dispatch") == after["dispatches"] - before["dispatches"] > 0
    assert grew("serve.decode", "rows") == grew("batch.queue_wait", "rows") == 6
    assert grew("batch.dispatch", "rows") == after["images"] - before["images"] == 6
    assert grew("serve.parse", "bytes") > 0 and grew("serve.respond", "bytes") > 0
    for name, total in spans.items():
        assert prometheus_value(text, "protoclip_spans_total", route="/encode",
                                span=name) == total["count"]
        assert prometheus_value(text, "protoclip_span_seconds_total", route="/encode",
                                span=name) == pytest.approx(total["total_ms"] / 1e3)


def test_metrics_prometheus_exposition_as_the_jax_server(server):
    srv, bundle = server
    port = srv.server_address[1]
    arr = np.random.default_rng(21).integers(0, 256, (32, 32, 3)).astype(np.uint8)
    assert _post(port, "/encode", {"images": [_b64_jpeg(arr)]})[0] == 200
    assert _post(port, "/nope", {})[0] == 404
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics") as req:
        assert req.headers["Content-Type"].startswith("text/plain")
        text = req.read().decode()
    sample = re.compile(r'^[a-z_]+(\{[a-z]+="[^"]*"(,[a-z]+="[^"]*")*\})? [-0-9.e+]+$')
    for line in text.strip().split("\n"):
        if not line.startswith("#"):
            assert sample.match(line), line
    assert prometheus_value(text, "protoclip_http_responses_total", route="/encode",
                            code=200) >= 1
    assert prometheus_value(text, "protoclip_http_responses_total", route="other", code=404) >= 1
    statz = json.loads(_get(port, "/statz")[1])["/encode"]
    assert prometheus_value(text, "protoclip_dispatches_total", route="/encode") \
        == statz["dispatches"]
    assert prometheus_value(text, "protoclip_images_total", route="/encode") == statz["images"]
    assert prometheus_value(text, "protoclip_batch_size", route="/encode") == statz["batch_size"]
    assert prometheus_value(text, "protoclip_dispatch_latency_ms", route="/encode",
                            quantile="0.5") > 0

    jsrv = jax_build_server(port=0, bundle=bundle, quiet=True)
    thread = _start(jsrv)
    try:
        jport = jsrv.server_address[1]
        assert _post(jport, "/encode", {"images": [_b64_jpeg(arr)]})[0] == 200
        jtext = _get(jport, "/metrics")[1].decode()
    finally:
        _stop(jsrv, thread)
    # the JAX server's families, and the port's span totals
    assert _families(text) == sorted(_families(jtext) + SPAN_FAMILIES)
    assert ({re.sub(r" \S+$", "", line) for line in text.splitlines() if "/encode" in line}
            >= {re.sub(r" \S+$", "", line) for line in jtext.splitlines()
                if "/encode" in line and "responses" not in line})


def test_healthz_degrades_on_dispatch_failures(server):
    srv, _ = server
    port = srv.server_address[1]
    batcher = srv.RequestHandlerClass.routes["/encode"].batcher
    real_run = batcher._run_batch
    payload = {"images": [_b64_jpeg(np.random.default_rng(33).integers(
        0, 256, (32, 32, 3)).astype(np.uint8))]}

    def boom(block):
        raise RuntimeError("device vanished")

    batcher._run_batch = boom
    try:
        for _ in range(3):
            status, body = _post(port, "/encode", payload)
            assert status == 500 and "device vanished" in body["error"]
        assert 'protoclip_dispatch_failures_total{route="/encode"} 3' in \
            _get(port, "/metrics")[1].decode()
        status, raw = _get(port, "/healthz")
        health = json.loads(raw)
        assert status == 503 and health["status"] == "degraded"
        assert health["routes"]["/encode"]["consecutive_failures"] >= 3
        assert "device vanished" in health["routes"]["/encode"]["last_error"]
    finally:
        batcher._run_batch = real_run
    assert _post(port, "/encode", payload)[0] == 200
    assert json.loads(_get(port, "/healthz")[1])["status"] == "ok"
    stats = json.loads(_get(port, "/statz")[1])["/encode"]
    assert stats["failures"] == 4 and stats["consecutive_failures"] == 0


def test_degraded_healthz_self_recovers_without_traffic(server, monkeypatch):
    srv, _ = server
    port = srv.server_address[1]
    batcher = srv.RequestHandlerClass.routes["/encode"].batcher
    real_run = batcher._run_batch
    monkeypatch.setattr(srv.RequestHandlerClass, "probe_interval_s", 0.0)
    payload = {"images": [_b64_jpeg(np.zeros((32, 32, 3), np.uint8))]}

    def boom(block):
        raise RuntimeError("card lost")

    batcher._run_batch = boom
    try:
        for _ in range(3):
            assert _post(port, "/encode", payload)[0] == 500
        assert _get(port, "/healthz")[0] == 503
    finally:
        batcher._run_batch = real_run
    status, raw = _get(port, "/healthz")
    assert status == 200 and json.loads(raw)["status"] == "ok"


def test_degraded_healthz_is_bounded_under_hung_probe(server, monkeypatch):
    srv, _ = server
    port = srv.server_address[1]
    batcher = srv.RequestHandlerClass.routes["/encode"].batcher
    real_run = batcher._run_batch
    monkeypatch.setattr(srv.RequestHandlerClass, "probe_interval_s", 0.0)
    monkeypatch.setattr(srv.RequestHandlerClass, "probe_join_s", 0.3)
    payload = {"images": [_b64_jpeg(np.zeros((32, 32, 3), np.uint8))]}

    def boom(block):
        raise RuntimeError("card gone")

    batcher._run_batch = boom
    released = threading.Event()
    try:
        for _ in range(3):
            assert _post(port, "/encode", payload)[0] == 500
        hung = threading.Event()

        def hang(block):
            hung.set()
            released.wait(30.0)
            return real_run(block)

        batcher._run_batch = hang
        t0 = time.monotonic()
        assert _get(port, "/healthz")[0] == 503
        assert time.monotonic() - t0 < 5.0
        assert hung.wait(5.0), "the probe never reached the device"
        t0 = time.monotonic()
        assert _get(port, "/healthz")[0] == 503
        assert time.monotonic() - t0 < 1.0
    finally:
        released.set()
        time.sleep(0.4)
        batcher._run_batch = real_run
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        if _get(port, "/healthz")[0] == 200:
            break
        time.sleep(0.2)
    else:
        raise AssertionError("the replica never recovered")


def test_classify_route_matches_classify_objects_and_the_jax_route(classifier_env):  # noqa: F811
    """/classify over the port's fp32 classifier: six crops over max_batch 4
    (the split) equal ``classify_objects``, and JAX's ``make_classify_route``
    on JAX's classifier gives the same names and probabilities within 1e-5."""
    cfg, jcfg = _configs(classifier_env)
    clf = ProtoClipClassifier(cfg, **_triple(classifier_env), max_batch=4, device="cpu")
    jclf = JaxClassifier(jcfg, **_triple(classifier_env), max_batch=4)
    srv = build_server(port=0, classifier=clf, quiet=True)
    thread = _start(srv)
    try:
        port = srv.server_address[1]
        crops = [np.random.default_rng(7).integers(0, 256, (48, 52, 3)).astype(np.uint8)
                 for _ in range(6)]
        payload = {"images": [_b64_jpeg(c) for c in crops]}
        status, body = _post(port, "/classify", payload)
        assert status == 200
        n1, p1 = clf.classify_objects(crops[:4])
        n2, p2 = clf.classify_objects(crops[4:])
        assert body["classnames"] == [list(r) for r in n1 + n2]
        np.testing.assert_allclose(np.asarray(body["scores"]), np.concatenate([p1, p2]),
                                   atol=1e-6, rtol=0)
        health = json.loads(_get(port, "/healthz")[1])
        assert health["mode"] == "classify" and health["num_classes"] == 3
        assert health["device"] == "cpu"
        names, probs = ServeClient(f"http://127.0.0.1:{port}").classify(crops)
        assert names == body["classnames"]
        text = _get(port, "/metrics")[1].decode()
        assert prometheus_value(text, "protoclip_dispatches_total", route="/classify") >= 4
        assert prometheus_value(text, "protoclip_images_total", route="/classify") >= 12

        jroute, jinfo = jax_make_classify_route(jclf, coalesce_ms=0.0)
        route, info = make_classify_route(clf, coalesce_ms=0.0)
        try:
            jout, out = jroute(payload), route(payload)
        finally:
            for r in (jroute, route):
                r.batcher.close()
                r.pool.shutdown(wait=False)
        assert out["classnames"] == jout["classnames"] == body["classnames"]
        np.testing.assert_allclose(out["scores"], jout["scores"], atol=1e-5, rtol=0)
        assert {k: v for k, v in info.items() if k != "device"} == jinfo
    finally:
        _stop(srv, thread)
