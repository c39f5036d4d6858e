"""The port's data mesh (``protoclip_tpu_torch/parallel``) and everything that
takes one, against the JAX package's mesh runs and the port's own
unsharded runs, on the CPU.

The port's CPU mesh is a repeated device (``make_mesh(8, devices=["cpu"] *
8)``), the stand-in for the JAX tests' 8 virtual host devices.  The recipe
is tests/test_torch_runner.py's ``tiny_env`` (fp32, fake tokenizer); the
trained runs patch the port's adapter draw to JAX's, as
tests/test_torch_train_runner.py does.  Bars: the sharded encode is held to
the unsharded one at ``atol`` 1e-5 (JAX's bar, ``tests/test_e2e.py``) and
checked bit for bit where a shard's batch equals the unsharded batch; runs
against JAX at ``assert_results_match``'s and ``assert_trained_alike``'s
bars.  Multi-process runs spawn 2 and 4 gloo ranks (``file://``
rendezvous, a hard timeout), one intra-op thread each.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from protoclip_tpu.parallel import make_mesh as jax_make_mesh
from protoclip_tpu.train import qt_runner as jqt_runner
from protoclip_tpu.train import runner as jrunner

from protoclip_tpu_torch.cli import extract as extract_cli
from protoclip_tpu_torch.io.checkpoint import load_checkpoint_triple, save_checkpoint_triple
from protoclip_tpu_torch.parallel import (
    dryrun,
    fetch_to_host,
    init_distributed,
    make_mesh,
    make_sharded_encode,
    replicated,
    shard_batch,
    shard_qt_step,
)
from protoclip_tpu_torch.parallel import mesh as mesh_mod
from protoclip_tpu_torch.train import qt_runner, runner
from protoclip_tpu_torch.train.qt import QTTrainer
from tests.test_torch_runner import assert_results_match, configs, env, fake_tokenizer  # noqa: F401
from tests.test_torch_train_runner import (  # noqa: F401  (fixture)
    TRAIN,
    assert_trained_alike,
    jax_adapter_draw,
    jax_call,
)

CPU8 = ["cpu"] * 8


def cpu_mesh(n=8):
    return make_mesh(n, devices=["cpu"] * n)


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One PyTorch thread, as each gloo rank: a CPU mesh runs its shards one
    after another, and a pool of threads per worker beside XLA's 8 virtual
    devices oversubscribes the suite's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the mesh and its placement -----------------------------------------------------


def test_make_mesh_counts_and_refuses_what_does_not_exist():
    mesh = make_mesh(devices=CPU8)
    assert (mesh.size, mesh.offset, mesh.process_count) == (8, 0, 1)
    assert mesh.device == torch.device("cpu") and mesh.axis_names == ("data",)
    assert make_mesh(4, devices=CPU8).devices == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError, match="requested 9 devices, only 8 available"):
        make_mesh(9, devices=CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(1)


def test_shard_batch_keeps_row_order_and_refuses_a_ragged_batch():
    mesh = cpu_mesh(4)
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    batch = shard_batch(x, mesh)
    assert [s.shape[0] for s in batch.shards] == [2] * 4
    assert shard_batch(batch, mesh) is batch
    np.testing.assert_array_equal(fetch_to_host(batch), x)
    with pytest.raises(ValueError, match="does not divide over a mesh of 4"):
        shard_batch(x[:6], mesh)
    weights = replicated(mesh).put({"w": torch.ones(3)})
    assert list(weights.copies) == [torch.device("cpu")]  # one copy per distinct device


def _runner_encodes(env, mesh):
    cfg, jcfg = configs(env, "tiny", "encode")
    ours = runner.make_encode_fns(cfg, mesh=mesh)[0]
    single = runner.make_encode_fns(cfg, device="cpu")[0]
    jax_mesh = jrunner.make_encode_fns(jcfg, jax_make_mesh(8))[0]
    return ours, single, jax_mesh


def test_sharded_encode_matches_jax_mesh_and_unsharded(env):
    """``make_encode_fns(cfg, mesh)`` on the 8-entry CPU mesh against JAX's
    on its 8 virtual devices and against the port unsharded (fp32, atol
    1e-5); distinct inputs give distinct rows (a broadcast-one-shard bug
    keeps the shapes)."""
    ours, single, jax_mesh = _runner_encodes(env, cpu_mesh())
    images = np.random.default_rng(7).integers(0, 256, (16, 32, 32, 3)).astype(np.uint8)
    feats = fetch_to_host(ours(images))
    assert feats.shape == (16, 32)
    np.testing.assert_allclose(feats, fetch_to_host(single(images)), atol=1e-5, rtol=0)
    np.testing.assert_allclose(feats, np.asarray(jax_mesh(images)), atol=1e-5, rtol=0)
    assert not np.allclose(feats[0], feats[1])
    # a shard's rows are the unsharded encode of those rows, bit for bit
    np.testing.assert_array_equal(feats[:2], fetch_to_host(single(images[:2])))


def test_sharded_encode_launches_every_shard_before_reading_back():
    mesh = cpu_mesh(4)
    order = []

    def encode(params, shard):
        order.append(("launch", int(shard[0, 0])))
        return shard * params

    out = make_sharded_encode(encode, mesh)(torch.tensor(2.0),
                                            np.arange(8, dtype=np.float32).reshape(8, 1))
    assert order == [("launch", r) for r in (0, 2, 4, 6)]
    np.testing.assert_array_equal(out.numpy()[:, 0], 2 * np.arange(8))


# -- the runners under a mesh ---------------------------------------------------------


def test_run_with_mesh_matches_jax_mesh_run_and_trains_on_one_device(env, capsys):
    """``run(cfg, mesh=...)``: the encodes sharded, episodic training on
    the mesh's first device; results and trained state as JAX's
    ``run(cfg, mesh=make_mesh(8))`` (its vocab-blocked
    ``test_full_runner_with_mesh``, here with the fake tokenizer)."""
    cfg, _ = configs(env, "tiny", "port_mesh", **TRAIN)
    _, jcfg = configs(env, "tiny", "jax_mesh", **TRAIN)
    ours = runner.run(cfg, progress=True, mesh=cpu_mesh())
    assert "[mesh] episodic training runs on one device" in capsys.readouterr().out
    logger = jrunner.MetricLogger(jcfg.logs_dir_path, use_tensorboard=False)
    try:
        ref = jrunner.run(jcfg, mesh=jax_make_mesh(8), progress=False, logger=logger)
    finally:
        logger.close()
    assert_trained_alike(cfg, jcfg, ours, ref)


def test_run_qt_with_mesh_odd_batch_matches_jax(env):
    """``run_qt(cfg, mesh=...)`` with batch 6 over 8 devices (JAX's
    ``test_qt_run_with_mesh_odd_batch``): clamped to the 6 train images,
    rounded up to 8, the padded rows dropped; trained as JAX's mesh run."""
    kw = dict(TRAIN, train_epoch=2, batch_size=6)
    cfg, _ = configs(env, "tiny", "port_qt_mesh", **kw)
    _, jcfg = configs(env, "tiny", "jax_qt_mesh", **kw)
    ours = qt_runner.run_qt(cfg, progress=False, mesh=cpu_mesh())
    logger = jrunner.MetricLogger(jcfg.logs_dir_path, use_tensorboard=False)
    try:
        ref = jqt_runner.run_qt(jcfg, mesh=jax_make_mesh(8), progress=False, logger=logger)
    finally:
        logger.close()
    assert_trained_alike(cfg, jcfg, ours, ref, qt=True)
    assert runner.mesh_batch(6, cpu_mesh()) == 8


def test_shard_qt_step_gathers_rows_in_order_then_steps():
    """``shard_qt_step`` (the trainer's mesh step): every shard encodes with
    its device's weights, the global batch's fp32 features reach the step
    in row order with no autograd, and ``step.encode`` is that encode."""
    mesh = cpu_mesh(4)
    images = np.arange(8 * 3, dtype=np.uint8).reshape(8, 3)
    seen = []

    def encode_fn(params, shard):
        return (shard.to(torch.bfloat16) * params["scale"]).requires_grad_()

    def step_on_features(feats, labels, n_valid):
        seen.append((feats, labels, n_valid))
        return {"loss": float(feats.sum())}

    step = shard_qt_step(step_on_features, encode_fn, mesh)
    weights = replicated(mesh).put({"scale": torch.tensor(2.0, dtype=torch.bfloat16)})
    labels = np.arange(8)
    stats = step(weights, images, labels, 7)
    feats, got_labels, n_valid = seen[0]
    want = torch.from_numpy(images).float() * 2
    assert feats.dtype == torch.float32 and not feats.requires_grad
    torch.testing.assert_close(feats, want, rtol=0, atol=0)
    assert got_labels is labels and n_valid == 7 and stats == {"loss": float(want.sum())}
    torch.testing.assert_close(step.encode(weights, images), want, rtol=0, atol=0)


def test_checkpoint_writers_never_share_a_tmp_file(tmp_path):
    """Every rank of a mesh run writes the same triple: concurrent writers
    each rename a whole file into place and leave no tmp file."""
    paths = [str(tmp_path / f"m_{s}.pt") for s in "vta"]
    bank_v, bank_t = np.ones((4, 8), np.float32), np.full((2, 8), 2.0, np.float32)
    state = {"fc.weight": np.eye(8, dtype=np.float32)}
    errors = []

    def write():
        try:
            for _ in range(10):
                save_checkpoint_triple(*paths, bank_v, bank_t, state)
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=write) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    assert errors == []
    v, t, a = load_checkpoint_triple(*paths)
    np.testing.assert_array_equal(v, bank_v)
    np.testing.assert_array_equal(a["fc.weight"], state["fc.weight"])
    assert sorted(os.listdir(tmp_path)) == sorted(os.path.basename(p) for p in paths)


# -- several processes ----------------------------------------------------------------


@pytest.mark.parametrize("processes", [2, 4])
def test_gloo_ranks_agree_and_equal_one_process(processes):
    """``processes`` gloo ranks, one CPU shard each, run the global-batch
    encode and one Q^T step: every rank's features, loss and parameters
    bit-identical, and equal bit for bit to one process with the same mesh
    (the same per-shard batch), and to the unsharded encode within 1e-5."""
    ranks = dryrun.run_ranks(dryrun.global_qt_step, processes, timeout_s=240,
                             n_devices=processes, device="cpu")
    dryrun.assert_ranks_agree(ranks)
    alone = dryrun.run_ranks(dryrun.global_qt_step, 1, timeout_s=240, n_devices=processes,
                             device="cpu")
    dryrun.assert_ranks_agree([alone[0], ranks[0]])
    cfg, params = dryrun._tiny_clip("cpu")
    rng = np.random.default_rng(0)  # qt_step's draws: the banks, then the images
    rng.standard_normal((dryrun.N_CLASS * dryrun.K_SHOTS, cfg.embed_dim))
    rng.standard_normal((dryrun.N_CLASS, cfg.embed_dim))
    images = rng.integers(0, 256, (2 * processes, 32, 32, 3)).astype(np.uint8)
    unsharded = QTTrainer(clip_params=params, clip_cfg=cfg,
                          bank_v_init=np.zeros((32, 32), np.float32),
                          bank_t_init=np.zeros((8, 32), np.float32), n_class=8, k_shots=4,
                          adapter_kind="fc", alpha=0.5, beta=10.0, compute_dtype="float32",
                          device="cpu").encode(images).numpy()
    np.testing.assert_allclose(ranks[0]["features"], unsharded, atol=1e-5, rtol=0)


def test_init_distributed_env_fallbacks(monkeypatch, capsys):
    """``$PROTOCLIP_*`` feed the rendezvous verbatim, the launcher's
    variables stand in for them, a partial spec names what is missing, a
    group already up is not formed again, and nothing set means one
    process (with a diagnostic), as JAX's ``init_distributed``."""
    calls = []
    monkeypatch.setattr(mesh_mod.dist, "init_process_group",
                        lambda backend, **kw: calls.append(dict(kw, backend=backend)))
    monkeypatch.setattr(mesh_mod, "_group_up", lambda: False)
    monkeypatch.setattr(mesh_mod, "_local_device_ids", None)
    for var in ("PROTOCLIP_COORDINATOR", "PROTOCLIP_NUM_PROCESSES", "PROTOCLIP_PROCESS_ID",
                "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)

    assert init_distributed() is False
    assert "continuing single-process" in capsys.readouterr().err and calls == []

    monkeypatch.setenv("PROTOCLIP_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("PROTOCLIP_NUM_PROCESSES", "4")
    with pytest.raises(ValueError, match=r"missing process_id \(\$PROTOCLIP_PROCESS_ID\)"):
        init_distributed()
    monkeypatch.setenv("PROTOCLIP_PROCESS_ID", "2")
    assert init_distributed(backend="gloo") is True
    assert calls[-1]["init_method"] == "tcp://10.0.0.1:1234"
    assert (calls[-1]["world_size"], calls[-1]["rank"], calls[-1]["backend"]) == (4, 2, "gloo")

    for var in ("PROTOCLIP_COORDINATOR", "PROTOCLIP_NUM_PROCESSES", "PROTOCLIP_PROCESS_ID"):
        monkeypatch.delenv(var)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert init_distributed(backend="gloo") is True
    assert (calls[-1]["init_method"], calls[-1]["world_size"], calls[-1]["rank"]) == (
        "tcp://127.0.0.1:29500", 2, 1)
    assert init_distributed("file:///tmp/x", 2, 0, backend="gloo") is True
    assert calls[-1]["init_method"] == "file:///tmp/x"

    # a group already up is reported, not formed again
    n_calls = len(calls)
    monkeypatch.setattr(mesh_mod, "_group_up", lambda: True)
    monkeypatch.setattr(mesh_mod.dist, "get_world_size", lambda: 4)
    assert init_distributed() is True and len(calls) == n_calls


def test_dryrun_multigpu_on_the_cpu():
    """The dry run's every leg on an 8-entry CPU mesh, then over 2 gloo
    ranks of 4 shards each."""
    assert "8-device mesh OK" in dryrun.dryrun_multigpu(8, device="cpu")
    assert "2-process x 4-device gloo group OK" in dryrun.dryrun_multigpu(8, processes=2,
                                                                          device="cpu")


@pytest.mark.parametrize("processes", [1, 2])
def test_dryrun_defaults_to_the_cards(monkeypatch, processes):
    """Without ``device`` the dry run shards over the cards, in one process
    and with ranks alike: without CUDA it raises before it spawns a rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.dryrun_multigpu(2, processes=processes)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.main(["--devices", "2", "--processes", str(processes)])


@pytest.mark.parametrize("cards, backend, ids", [
    (8, "nccl", [[0, 1], [2, 3]]),
    (4, "nccl", [[0, 1], [2, 3]]),
    (2, "gloo", [[0, 1], [0, 1]]),
    (1, "gloo", [[0, 0], [0, 0]]),
])
def test_dryrun_ranks_own_their_cards(monkeypatch, cards, backend, ids):
    """Rank ``r`` of the dry run drives its own slice of the cards over
    NCCL; only with fewer cards than shards do ranks share cards (gloo)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert dryrun.rank_cards(4, 2) == (backend, ids)


# -- the CLIs -------------------------------------------------------------------------


def test_extract_cli_mesh_bit_exact_and_rounds_the_batch_up(env, tmp_path, monkeypatch):
    """``--mesh 8`` gives the unsharded run's rows at the same per-shard
    batch bit for bit and, at batch 16, within 1e-5; batch 6 rounds up to 8
    (tests/test_e2e.py:438-470's case)."""
    img_dir = os.path.join(env["root"], "caltech-101", "101_ObjectCategories")
    base = ["extract", "--backbone", "tiny", "--weights", env["weights"]["tiny"], "--input",
            img_dir, "--device", "cpu"]

    def extract(name, *flags):
        out = str(tmp_path / f"{name}.npz")
        monkeypatch.setattr("sys.argv", base + ["--out", out, *flags])
        extract_cli.main()
        with np.load(out) as z:
            return list(z["files"]), z["features"]

    files_s, single = extract("single", "--batch", "16")
    files_2, per_shard = extract("per_shard", "--batch", "2")
    files_m, meshed = extract("meshed", "--batch", "16", "--mesh", "8")
    assert files_s == files_m == files_2
    np.testing.assert_array_equal(meshed, per_shard)
    np.testing.assert_allclose(meshed, single, atol=1e-5, rtol=0)
    _, ragged = extract("ragged", "--batch", "6", "--mesh", "8")
    np.testing.assert_allclose(ragged, single, atol=1e-5, rtol=0)
    assert not [f for f in os.listdir(tmp_path) if ".tmp-" in f]


# -- serving over the mesh ------------------------------------------------------------


def test_mesh_encode_route_matches_direct_calls_and_healthz():
    """``build_server(mesh_devices=8, per_device_batch=1)``: /healthz's
    mesh keys, and 11 images over a global batch of 8 equal to direct
    ``make_encode_fn`` calls (fp32 weights; atol 1e-5) and to JAX's mesh
    route on the same weights (tests/test_serve.py:601-651)."""
    import json
    import urllib.request

    from PIL import Image

    import jax

    from protoclip_tpu.cli.serve import build_server as jax_build_server
    from protoclip_tpu.models.clip import init_clip_params as jax_init_clip_params

    from protoclip_tpu_torch.cli.serve import build_server
    from protoclip_tpu_torch.data.transforms import clip_preprocess
    from protoclip_tpu_torch.io.export import make_encode_fn
    from protoclip_tpu_torch.models.clip import params_from_jax
    from tests.test_models import TINY_VIT
    from tests.test_serve import _b64_jpeg, _post
    from tests.test_torch_models import port_config

    cfg = port_config(TINY_VIT)
    jparams = jax_init_clip_params(jax.random.PRNGKey(3), TINY_VIT)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    rng = np.random.default_rng(7)
    arrays = [rng.integers(0, 256, (40 + i, 37 + i, 3)).astype(np.uint8) for i in range(11)]
    payload = {"images": [_b64_jpeg(a) for a in arrays]}
    served = {}
    for name, build in (
        ("port", lambda: build_server(port=0, clip=(cfg, params), mesh_devices=8,
                                      per_device_batch=1, quiet=True, coalesce_ms=0.0,
                                      device="cpu")),
        ("jax", lambda: jax_build_server(port=0, clip=(TINY_VIT, jparams), mesh_devices=8,
                                         per_device_batch=1, quiet=True, coalesce_ms=0.0)),
    ):
        srv = build()
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        port = srv.server_address[1]
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as resp:
                health = json.loads(resp.read())
            status, body = _post(port, "/encode", payload)
            assert status == 200
            served[name] = (health, np.asarray(body["features"], np.float32))
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=5)
            assert not thread.is_alive()
    health, feats = served["port"]
    keys = ("mode", "mesh_devices", "per_device_batch", "batch_size", "backbone", "int8",
            "int8_weights_prequantized")
    assert {k: health[k] for k in keys} == {k: served["jax"][0][k] for k in keys} == {
        "mode": "encode", "mesh_devices": 8, "per_device_batch": 1, "batch_size": 8,
        "backbone": "tiny-vit", "int8": False, "int8_weights_prequantized": False}
    assert feats.shape == (11, 32)
    block = np.stack([clip_preprocess(Image.fromarray(a), 32) for a in arrays])
    want = make_encode_fn(cfg)(params, torch.from_numpy(block)).numpy()
    np.testing.assert_allclose(feats, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(feats, served["jax"][1], atol=1e-5, rtol=0)


def test_mesh_route_int8_reporting_and_bundle_exclusion(monkeypatch, tmp_path):
    """/healthz's ``int8`` is the mode the route serves (read once, at
    construction), ``int8_weights_prequantized`` whether the weights carry
    load-time int8 layers; the int8 route serves K3's plain version here,
    unit-norm rows.  A bundle and the mesh mode together are refused."""
    from protoclip_tpu_torch.cli.serve import build_server, make_mesh_encode_route
    from protoclip_tpu_torch.io.export import save_serving_bundle
    from protoclip_tpu_torch.models.clip import quantize_for_serving
    from tests.test_serve import _b64_jpeg

    cfg, params = dryrun._tiny_clip("cpu")
    for int8, weights, prequantized in ((False, quantize_for_serving(params), True),
                                        (True, params, False)):
        if int8:
            monkeypatch.setenv("PROTOCLIP_INT8", "1")
        else:
            monkeypatch.delenv("PROTOCLIP_INT8", raising=False)
        route, info = make_mesh_encode_route(clip=(cfg, weights), mesh_devices=8,
                                             per_device_batch=1, warmup=True,
                                             coalesce_ms=0.0, device="cpu")
        monkeypatch.delenv("PROTOCLIP_INT8", raising=False)  # read once: no effect now
        try:
            assert (info["int8"], info["int8_weights_prequantized"]) == (int8, prequantized)
            out = route({"images": [_b64_jpeg(np.zeros((32, 32, 3), np.uint8))]})
            feats = np.asarray(out["features"], np.float32)
            assert feats.shape == (1, 32) and np.isfinite(feats).all()
            np.testing.assert_allclose(np.linalg.norm(feats, axis=-1), 1.0, atol=1e-3)
        finally:
            route.batcher.close()
            route.pool.shutdown(wait=False)
    bundle = str(tmp_path / "bundle")
    save_serving_bundle(bundle, cfg, params, batch_size=2)
    with pytest.raises(ValueError, match="pick one"):
        build_server(port=0, bundle=bundle, clip=(cfg, params), device="cpu")
