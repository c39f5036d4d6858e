"""The port's remaining tools (``protoclip_tpu_torch/scripts/``) on the CPU,
at tiny sizes, against the JAX package's scripts where both can run here:

- ``validate_bundle`` (``scripts/validate_bundle_tpu.py``): its JSON keys
  are the JAX script's (read from its source); the reloaded rows equal the live encode bit for bit
  (bf16 and int8) and JAX's live bf16 encode of the same weights within
  tests/test_torch_export.py's bars (max|diff| / max|JAX| < 1e-2, cosine >
  0.9999); a perturbed weight in the written ``params.npz`` fails it;
- ``bench_serve_http``: serial dispatches equal the requests, concurrent
  ones are at most that, and the server is stopped, also when the bench
  fails;
- ``bench_int8_peak``: the int8 checksum equals numpy's int64 product
  exactly, K3.c's plain output equals ``torch._int_mm``'s, K2.b's holds
  ``torch.matmul``'s at bf16's bars and a K2.b that skips half of K fails;
- ``bench_rn50_int8``: each shape's int8 products against ``F.conv2d`` at a
  cosine >= 0.99, the 4608-wide shape left out of the dynamic line and its
  sum; the JAX script's recipe (HWIO weights against patches in
  (C, kh, kw) order) is off the convolution by more than that bar;
- ``bench_episodic_sharding``: the query-sharded epochs' parameters equal
  the replicated ones within 1e-6 (fp32) on meshes of 2 and 4 CPU devices,
  with L2 and L3 counted once; its JSON keys hold the JAX script's (read
  from its source);
- ``run_all_benchmarks.sh``: line for line the JAX script's, but for the
  module and ``--device``.
"""

import ast
import json
import os
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from protoclip_tpu.io.export import make_encode_fn as jax_make_encode_fn
from protoclip_tpu.models import load_clip as jax_load_clip

from protoclip_tpu_torch.io import export
from protoclip_tpu_torch.ops import kernels as K
from protoclip_tpu_torch.scripts import bench_episodic_sharding as bes
from protoclip_tpu_torch.scripts import bench_int8_peak, bench_rn50_int8, bench_serve_http
from protoclip_tpu_torch.scripts import validate_bundle as vb
from tests.test_models import _tiny_torch_style_state_dict
from tests.test_torch_export import BF16_BARS, _bars

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory):
    """The tiny ViT's state dict as ``tiny.pt`` (the port) and ``tiny.pkl``
    (the JAX package) in one directory, for ``$PROTOCLIP_WEIGHTS_DIR``."""
    import pickle

    sd = _tiny_torch_style_state_dict(np.random.default_rng(0))
    root = tmp_path_factory.mktemp("weights")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, root / "tiny.pt")
    with open(root / "tiny.pkl", "wb") as fh:
        pickle.dump({k: np.asarray(v) for k, v in sd.items()}, fh)
    return str(root)


def json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


# -- validate_bundle --------------------------------------------------------------


def bundle_args(*extra):
    return vb.build_parser().parse_args(["--backbone", "tiny.pt", "--device", "cpu",
                                         "--batch", "4", "--buckets", "2", "--iters", "1",
                                         *extra])


def jax_script_keys(name, var):
    """The string keys of the dict literal assigned to ``var`` in the JAX
    script ``scripts/<name>`` (its printed JSON line), read from its source."""
    tree = ast.parse((REPO / "scripts" / name).read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == var for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no {var} = {{...}} in {name}")


def test_validate_bundle_keys_and_rows_match_jax(weights_dir, monkeypatch, capsys):
    monkeypatch.setenv("PROTOCLIP_WEIGHTS_DIR", weights_dir)
    monkeypatch.delenv("PROTOCLIP_INT8", raising=False)
    assert vb.main(["--backbone", "tiny.pt", "--device", "cpu", "--batch", "4",
                    "--buckets", "2", "--iters", "1"]) == 0
    line = json_lines(capsys.readouterr().out)[-1]
    # the JAX script's line, plus one f"bucket_{size}_ms_per_dispatch" a bucket
    assert set(line) == jax_script_keys("validate_bundle_tpu.py", "line") | {
        "bucket_2_ms_per_dispatch"}

    rows = vb.validate(bundle_args())["rows"]
    cfg, params = jax_load_clip("tiny.pkl", dtype=jnp.bfloat16)
    images = np.random.default_rng(0).integers(0, 256, (4, 32, 32, 3)).astype(np.uint8)
    want = np.asarray(jax.jit(jax_make_encode_fn(cfg))(params, jnp.asarray(images)))
    assert rows.shape == want.shape == (4, 32)
    _bars(rows, want, BF16_BARS)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_validate_bundle_is_exact_against_the_live_encode(weights_dir, monkeypatch, int8):
    """The reloaded bundle equals the live encode bit for bit (the check the
    script makes), in both modes, with no process-wide mode set."""
    monkeypatch.setenv("PROTOCLIP_WEIGHTS_DIR", weights_dir)
    monkeypatch.delenv("PROTOCLIP_INT8", raising=False)
    calls = {"K3": 0}
    real = K.fused_transformer_block_int8_plain

    def counted(*args, **kwargs):
        calls["K3"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(K, "fused_transformer_block_int8_plain", counted)
    result = vb.validate(bundle_args(*(["--int8"] if int8 else [])))
    assert result["failure"] is None
    assert set(result["line"]) >= {"bundle_images_per_sec_device_input", "ms_per_batch",
                                   "bucket_2_ms_per_dispatch"}
    assert (calls["K3"] > 0) == int8


def test_validate_bundle_fails_on_a_perturbed_weight(weights_dir, monkeypatch, capsys):
    monkeypatch.setenv("PROTOCLIP_WEIGHTS_DIR", weights_dir)
    real = export.save_serving_bundle

    def save_then_perturb(path, *args, **kwargs):
        real(path, *args, **kwargs)
        npz = os.path.join(path, "params.npz")
        with np.load(npz) as fh:
            flat = {k: fh[k].copy() for k in fh.files}
        key = "visual/blocks/0/attn/wo"
        flat[key].flat[0] ^= 0x40  # one bf16 weight's bits (stored as uint16)
        np.savez(npz, **flat)

    monkeypatch.setattr(export, "save_serving_bundle", save_then_perturb)
    rc = vb.main(["--backbone", "tiny.pt", "--device", "cpu", "--batch", "4", "--iters", "1"])
    captured = capsys.readouterr()
    assert rc == 1
    assert "FAIL: bundle output diverges from live path" in captured.err
    assert not json_lines(captured.out)


# -- bench_serve_http ---------------------------------------------------------------


@pytest.fixture()
def recorded_children(monkeypatch):
    """Every child the bench starts (``subprocess.run`` goes through
    ``Popen`` too)."""
    children = []
    real = subprocess.Popen

    class Recording(real):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            children.append(self)

    monkeypatch.setattr(bench_serve_http.subprocess, "Popen", Recording)
    return children


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_bench_serve_http_counts_dispatches_and_stops_the_server(
        weights_dir, monkeypatch, tmp_path, capfd, recorded_children):
    monkeypatch.setenv("PROTOCLIP_WEIGHTS_DIR", weights_dir)
    bundle = str(tmp_path / "bundle")
    argv = ["--backbone", "tiny.pt", "--device", "cpu", "--batch", "4", "--bundle", bundle,
            "--requests", "4", "--images-per-request", "2", "--warmup-timeout", "120"]
    assert bench_serve_http.main([*argv, "--port", str(free_port())]) == 0
    line = json_lines(capfd.readouterr().out)[-1]
    assert line["metric"] == "serve_coalesce_speedup"
    assert {"serial_img_per_s", "concurrent_img_per_s", "speedup", "serial_dispatches",
            "concurrent_dispatches"} <= set(line)
    assert line["serial_dispatches"] == 4
    assert 1 <= line["concurrent_dispatches"] <= 4
    assert line["serial_mean_fill"] == 2.0
    # the export child and the server, both ended
    assert len(recorded_children) == 2
    assert all(child.poll() is not None for child in recorded_children)

    # a bench that fails once the server is started still stops it
    def broken(*args):
        raise RuntimeError("client failure")

    monkeypatch.setattr(bench_serve_http, "wait_healthz", broken)
    with pytest.raises(RuntimeError, match="client failure"):
        bench_serve_http.main([*argv, "--skip-export", "--port", str(free_port())])
    assert len(recorded_children) == 3 and recorded_children[2].poll() is not None


# -- bench_int8_peak ---------------------------------------------------------------------


def test_bench_int8_peak_checksum_is_exact(capsys):
    n, steps = 64, 2
    assert bench_int8_peak.main([str(n), str(steps), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    line = json_lines(out)[-1]
    gen = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (n, n), generator=gen, dtype=torch.int8).numpy()
    b_nk = torch.randint(-127, 128, (n, n), generator=gen, dtype=torch.int8).numpy()
    exact = steps * int((a.astype(np.int64) @ b_nk.T.astype(np.int64)).sum())
    assert line["int8_checksum_exact"] == exact
    assert line["forms"]["int8->int32"]["checksum"] == exact
    assert line["gemm_int8_epilogue_vs_int_mm_max_abs_diff"] == 0.0
    assert line["gemm_bias_epilogue_vs_matmul_max_rel_diff"] <= bench_int8_peak.K2B_MAX_REL
    assert line["gemm_bias_epilogue_vs_matmul_min_row_cosine"] >= bench_int8_peak.K2B_MIN_COSINE
    assert line["forms"]["gemm_int8_epilogue"]["ran"].startswith("plain: K3.c")
    assert line["forms"]["gemm_bias_epilogue"]["ran"].startswith("plain: K2.b")
    assert line["timer"] == "host_clock" and line["ok"]
    for tag in ("int8->int32 [library", "bf16->fp32 [library"):  # the JAX script's lines
        assert tag in out


def test_bench_int8_peak_fails_when_k2b_skips_work(monkeypatch, capsys):
    """A K2.b that drops the second half of K (as a kernel skipping tiles
    would) is caught by the check against ``torch.matmul``."""
    real = K.gemm_bias_epilogue

    def half_k(a, w, bias, epilogue, residual=None):
        k = a.shape[-1] // 2
        return real(a[:, :k], w[:k], bias, epilogue, residual)

    monkeypatch.setattr(K, "gemm_bias_epilogue", half_k)
    assert bench_int8_peak.main(["64", "1", "--device", "cpu"]) == 1
    line = json_lines(capsys.readouterr().out)[-1]
    assert line["gemm_bias_epilogue_vs_matmul_max_rel_diff"] > bench_int8_peak.K2B_MAX_REL
    assert not line["ok"]


# -- bench_rn50_int8 ------------------------------------------------------------------------


def test_bench_rn50_int8_products_are_the_convolution(monkeypatch, capsys):
    monkeypatch.setattr(bench_rn50_int8, "RUNS", 1)  # one timed run: the check is the cosine
    assert bench_rn50_int8.main(["2", "1", "--device", "cpu"]) == 0
    line = json_lines(capsys.readouterr().out)[-1]
    assert [s["name"] for s in line["shapes"]] == [s[0] for s in bench_rn50_int8.SHAPES]
    for shape in line["shapes"]:
        assert shape["i8pre_cosine_vs_bf16_conv"] >= 0.99, shape
        if shape["name"] in line["i8mm_left_out"]:
            assert shape["i8mm"] is None and shape["quantizer"].startswith("none: W=4608")
        else:
            assert shape["i8mm_cosine_vs_bf16_conv"] >= 0.99, shape
            assert shape["quantizer"] == "plain: the CPU"
    assert line["i8mm_left_out"] == ["layer4.conv2 3x3"]
    assert {"bf16", "bf16_i8mm_shapes", "i8mm", "i8pre", "int_mm"} == set(line["sum_ms"])
    dyn = [shape for shape in line["shapes"] if shape["i8mm"] is not None]
    assert line["sum_ms"]["i8mm"] == pytest.approx(sum(shape["i8mm"] for shape in dyn))
    assert line["speedup_dyn"] == pytest.approx(
        sum(shape["bf16"] for shape in dyn) / line["sum_ms"]["i8mm"])


def test_rn50_int8_im2col_orders_patches_as_unfold():
    """The int8 im2col (pad + shifted taps) is F.unfold's (C, kh, kw) order,
    and OIHW kernels reshaped to (cout, cin*k*k) against those rows are the
    convolution (fp32, within 1e-5)."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randint(-127, 128, (2, 5, 6, 6), generator=gen).to(torch.int8)
    x = x.contiguous(memory_format=torch.channels_last)
    want = bench_rn50_int8.im2col(x.float(), 3)
    np.testing.assert_array_equal(bench_rn50_int8.im2col(x, 3).float().numpy(), want.numpy())
    w = torch.randn((4, 5, 3, 3), generator=gen)
    conv = F.conv2d(x.float(), w, padding=1).permute(0, 2, 3, 1).reshape(-1, 4)
    np.testing.assert_allclose((want @ w.reshape(4, -1).t()).numpy(), conv.numpy(),
                               atol=1e-5 * float(conv.abs().max()), rtol=0)


def test_jax_rn50_recipe_is_off_the_convolution():
    """``scripts/bench_rn50_int8.py:110`` reshapes HWIO weights to
    (kh*kw*cin, cout) against ``conv_general_dilated_patches``, whose patch
    is (C, kh, kw): its product is not the convolution (a cosine under the
    int8 bar of 0.99), and is once the weights are put in (C, kh, kw) order."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((1, 6, 6, 5)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((3, 3, 5, 4)), jnp.float32)
    dn = ("NHWC", "HWIO", "NHWC")
    conv = jax.lax.conv_general_dilated(x, w, (1, 1), [(1, 1)] * 2, dimension_numbers=dn)
    patches = jax.lax.conv_general_dilated_patches(x, (3, 3), (1, 1), [(1, 1)] * 2,
                                                   dimension_numbers=dn).reshape(-1, 45)
    conv = np.asarray(conv).reshape(-1, 4).ravel()
    theirs = np.asarray(patches @ w.reshape(-1, 4)).ravel()
    fixed = np.asarray(patches @ w.transpose(2, 0, 1, 3).reshape(-1, 4)).ravel()
    cos = theirs @ conv / (np.linalg.norm(theirs) * np.linalg.norm(conv))
    assert cos < 0.99 and np.abs(theirs - conv).max() > 1.0, cos
    np.testing.assert_allclose(fixed, conv, atol=1e-4, rtol=0)


def test_rn50_wide_rows_are_left_out_of_the_dynamic_line():
    """layer4.conv2's 4608-wide rows are wider than quant_rows.cu takes (the
    probe gives that shape no dynamic line, rather than a plain quantizer
    on the card); K3.c's rules (K a multiple of 16, N of 8) hold for every
    shape."""
    wide = [name for name, _, cin, _, k in bench_rn50_int8.SHAPES
            if cin * k * k > K.QUANT_MAX_WIDTH]
    assert wide == ["layer4.conv2 3x3"]
    for _, _, cin, cout, k in bench_rn50_int8.SHAPES:
        assert (cin * k * k) % K.INT8_K_PIECE == 0 and cout % K.PIECE == 0
    with pytest.raises(ValueError, match="row width 4608"):
        K.require_quant_width("quant_rows", 4608, {})


# -- bench_episodic_sharding ---------------------------------------------------------------


TINY_EPISODES = ["--n-class", "20", "--k-shots", "4", "--dim", "64"]


@pytest.mark.parametrize("devices", [2, 4])
def test_sharded_episodic_epochs_equal_replicated(devices, capsys):
    assert bes.main(["--device", "cpu", "--devices", str(devices), "--repeats", "1",
                     *TINY_EPISODES]) == 0
    line = json_lines(capsys.readouterr().out)[-1]
    assert line["devices"] == devices and line["epochs"] == 2
    assert line["max_abs_param_diff"] <= 1e-6
    assert line["note"].startswith("every shard on one device")


def test_sharded_episodic_counts_l2_and_l3_once(monkeypatch, capsys):
    """Counting the prototype terms on every shard moves the parameters past
    the bar: the check above would see it."""
    real = bes.QueryShardedTrainer._shard_loss

    def on_every_shard(self, s, *args):
        return real(self, 0, *args)

    monkeypatch.setattr(bes.QueryShardedTrainer, "_shard_loss", on_every_shard)
    assert bes.main(["--device", "cpu", "--devices", "2", "--repeats", "1",
                     *TINY_EPISODES]) == 1
    assert json_lines(capsys.readouterr().out)[-1]["max_abs_param_diff"] > 1e-6


def test_episodic_sharding_keys_hold_the_jax_scripts(capsys):
    assert bes.main(["--device", "cpu", "--devices", "2", "--repeats", "1",
                     *TINY_EPISODES]) == 0
    line = json_lines(capsys.readouterr().out)[-1]
    assert jax_script_keys("bench_episodic_sharding.py", "out") <= set(line)
    assert line["timer"] == "steps only, a sync at each end" and line["epochs"] == 2
    low, median, high = line["pair_ratio_quartiles"]
    assert 0 < low <= median <= high
    assert (line["episodes_per_epoch"], line["query_buffer"]) == (5, 24)  # E and Q at N=20, K=4


# -- run_all_benchmarks.sh ---------------------------------------------------------------------


def test_run_all_benchmarks_is_the_jax_script_on_the_port():
    theirs = (REPO / "scripts" / "run_all_benchmarks.sh").read_text().splitlines()
    path = REPO / "protoclip_tpu_torch" / "scripts" / "run_all_benchmarks.sh"
    ours = [line for line in path.read_text().splitlines()
            if not line.startswith('DEVICE="${DEVICE:-cuda}"')]
    assert len(ours) == len(theirs)
    for mine, jax_line in zip(ours, theirs):
        assert (mine.replace("protoclip_tpu_torch.cli.main", "protoclip_tpu.cli.main")
                .replace(' --device "${DEVICE}"', "")) == jax_line
    assert sum('--device "${DEVICE}"' in line for line in ours) == 3
    assert os.access(path, os.X_OK)
    subprocess.run(["bash", "-n", str(path)], check=True, timeout=60)


def test_tools_default_to_the_card():
    for parser in (vb.build_parser(), bench_serve_http.build_parser(),
                   bench_int8_peak.build_parser(), bench_rn50_int8.build_parser(),
                   bes.build_parser()):
        assert parser.parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("the card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_int8_peak.main(["64", "1"])
