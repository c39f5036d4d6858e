"""The post-norm (EVA02-CLIP-bigE) pieces of the benchmark on the CPU: the
weights' layout against what the program's converter reads, the reference
against the tests' plain reference, the operation counts, the rows the
check holds, the readers, and planted faults in the program that make a
tiny post-norm bank cell's ``correct`` false.

The tiny cell runs in fp32 (width 64, 2 heads of 32, 2 layers, 56 px, MLP
480; text 64 wide, 2 layers) under a backbone registered for it, with
limits of its own: sound runs read under 1e-5 (the plain versions against
the reference differ in the order of fp32 sums).
"""

import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, work_eva_postnorm, weights_eva_postnorm
from benchmark.drivers.bank_int8 import rounded
from benchmark.drivers.bank_shm_postnorm import checked_rows
from benchmark.harness import Bench
from benchmark.reference import eva as ref_eva
from benchmark.reference.eva_postnorm import PostnormImageTower

from .conftest import make_tiny_root

_spec = importlib.util.spec_from_file_location(
    "eva_postnorm_reference",
    Path(__file__).resolve().parents[2] / "tests" / "eva_postnorm_reference.py")
postnorm_reference = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(postnorm_reference)

CELL = "eva02-bige-14-plus.bank-1024"
TINY_BACKBONE = "EVA02-CLIP-postnorm-tiny"
TINY_PN = {
    "name": "tiny-pn", "backbone": TINY_BACKBONE, "source": "test", "embed_dim": 32,
    "image_resolution": 56, "vision_layers": 2, "vision_width": 64, "vision_heads": 2,
    "vision_patch_size": 14, "vision_mlp_width": 480, "vision_block": "eva_postnorm",
    "context_length": 16, "vocab_size": 49408, "transformer_width": 64, "transformer_heads": 1,
    "transformer_layers": 2, "text_act": "gelu", "weights_dtype": "bfloat16",
    "compute_dtype": "float32", "outlier_gain": 16.0, "reduced": [], "assumed": [],
}
TINY_LIMITS = {"feature_err": 1e-5, "text_err": 1e-5}


@pytest.fixture
def registered(monkeypatch):
    from protoclip_tpu_torch.models import clip, eva

    monkeypatch.setitem(clip.PORT_BACKBONE_CONFIGS, TINY_BACKBONE, clip.CLIPConfig(
        TINY_BACKBONE, 32, 56, 2, 64, 14, context_length=16, transformer_width=64,
        transformer_layers=2, n_vision_heads=2, vision_block=eva.POSTNORM, vision_mlp_width=480,
        text_act="gelu"))


@pytest.fixture
def pn_bench(tmp_path, registered):
    """The tiny benchmark root with the bigE cell on the tiny post-norm
    configuration, 3 classes of 5 shots at batch 4, every second row held."""
    bench = make_tiny_root(tmp_path)
    data, real = bench.data, Bench()
    (data / "configs" / "tiny-pn.json").write_text(json.dumps(TINY_PN))
    (data / "cells" / f"{CELL}.json").write_text(json.dumps({"limits": TINY_LIMITS}))
    (data / "traffic" / "bank-1024-shm-postnorm.json").write_text(json.dumps(
        dict(real.traffic("bank-1024-shm-postnorm"), classes=3, shots=5, batch_size=4,
             check_every=2)))
    spec = bench.spec
    spec["configs"].append({"name": "tiny-pn", "source": "test", "reduced": [], "why": "CPU",
                            "file": "benchmark/configs/tiny-pn.json"})
    for w in spec["workloads"]:
        if w["name"] == CELL:
            w["config"] = "tiny-pn"
    (bench.root / "BENCHMARK.json").write_text(json.dumps(spec))
    return Bench(bench.root)


def _run(bench, trace=False):
    return harness.run_cell(CELL, 2 ** 31 + 13, 0.5, trace, t0=time.perf_counter(), device="cpu",
                            bench=bench, log=lambda line: None)


def test_layout_is_what_the_converter_reads(registered):
    from protoclip_tpu_torch.models import clip

    sd = weights_eva_postnorm.state_dict(TINY_PN, 3, "cpu")
    tiny = dict(postnorm_reference.TINY, vocab=TINY_PN["vocab_size"])
    layout = postnorm_reference.postnorm_state_dict(0, tiny)
    assert set(sd) == set(layout)
    for key, value in sd.items():
        assert value.shape == layout[key].shape and value.dtype == torch.bfloat16, key
    cfg, params = clip.convert_clip_state_dict(sd)
    assert cfg.name == TINY_BACKBONE and cfg.vision_heads == 2
    assert params["visual"]["blocks"][1]["mlp"]["w_fc"].shape == (64, 480)


def test_post_norm_scales_carry_the_depth_factor():
    cfg = dict(TINY_PN, vision_layers=8)
    sd = weights_eva_postnorm.state_dict(cfg, 4, "cpu")
    scales = torch.stack([sd[f"visual.blocks.{i}.norm1.weight"].float() for i in range(8)])
    gain = cfg["outlier_gain"]
    plain = scales[:, (scales[0] / scales[0].median()).abs() < gain / 2]
    assert plain.mean().item() == pytest.approx(16 ** -0.5, rel=0.05)
    assert sd["visual.norm.weight"].float().mean().item() == pytest.approx(1.0, abs=0.05)
    outliers = (scales[0] > gain / 2 * scales[0].median()).sum().item()
    assert outliers == max(1, round(0.01 * 64))


def test_reference_matches_the_tests_reference():
    sd = weights_eva_postnorm.state_dict(TINY_PN, 5, "cpu")
    images = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (3, 56, 56, 3),
                                                                dtype=np.uint8))
    ours = PostnormImageTower(sd, 2, "cpu", block=2)(images)
    theirs = postnorm_reference.EvaPostnormCLIP(sd, 2, 1)
    mean, std = torch.tensor(ref_eva.MEAN), torch.tensor(ref_eva.STD)
    torch.testing.assert_close(ours, theirs.encode_image((images / 255.0 - mean) / std),
                               rtol=1e-5, atol=1e-5)
    tokens = torch.zeros(4, 16, dtype=torch.long)
    tokens[:, 0], tokens[:, 1:5], tokens[:, 5] = 49406, torch.arange(1, 5), 49407
    torch.testing.assert_close(ref_eva.TextTower(sd, 1, "gelu", "text.", "cpu", block=3)(tokens),
                               theirs.encode_text(tokens), rtol=1e-5, atol=1e-5)


def test_work_counts_by_hand():
    cfg = Bench().config("eva02-bige-14-plus")
    length, d, h = 257, 1792, 15360
    block = 8 * length * d * d + 4 * length * d * h + 4 * length ** 2 * d
    flops = 2 * 256 * 588 * d + 64 * block + 2 * d * 1024
    assert work_eva_postnorm.image_flops(cfg) == flops
    assert flops / 1e12 == pytest.approx(2.264, abs=0.001)
    assert block / 1e9 == pytest.approx(35.37, abs=0.01)
    pieces = {p: (c, b, o) for p, c, b, o in work_eva_postnorm.encode_pieces(cfg, 1024)}
    m = 1024 * length
    assert pieces["postln_1"] == (64, 3 * m * d * 2 + 2 * d * 4, 10 * m * d)
    products = sum(c * o for p, c, _, o in work_eva_postnorm.encode_pieces(cfg, 1024)
                   if p not in ("postln_1", "postln_2", "ln_post"))
    assert products == 1024 * flops
    # the post-LN passes of a pass over the split: 1.12 TB
    per_pass = sum(c * b for p, c, b, _ in work_eva_postnorm.encode_pieces(cfg, 3168)
                   if p in work_eva_postnorm.POSTLN_PIECES)
    assert per_pass / 1e12 == pytest.approx(1.12, abs=0.01)


def test_the_check_holds_every_eighth_row_of_a_full_batch_and_the_short_batch():
    rows = checked_rows(3168, 1024, 8)
    assert len(rows) == 480 and rows[:3].tolist() == [0, 8, 16]
    assert rows[383] == 3064 and rows[384:].tolist() == list(range(3072, 3168))
    assert checked_rows(2048, 1024, 8).tolist() == list(range(0, 2048, 8))


def test_the_int8_cells_control_rounds_block_matrices_to_4_bits():
    sd = {"transformer.resblocks.0.mlp.c_fc.weight": torch.randn(8, 16).bfloat16(),
          "transformer.resblocks.0.ln_1.weight": torch.randn(16).bfloat16(),
          "visual.proj": torch.randn(16, 4).bfloat16()}
    out = rounded(sd, 4)
    w = out["transformer.resblocks.0.mlp.c_fc.weight"].float()
    step = sd["transformer.resblocks.0.mlp.c_fc.weight"].float().abs().amax(1, keepdim=True) / 7
    codes = w / step
    assert ((codes - codes.round()).abs() < 0.02).all() and codes.abs().max() <= 7.01
    for key in ("transformer.resblocks.0.ln_1.weight", "visual.proj"):
        assert torch.equal(out[key], sd[key])


def test_the_bige_control_rounds_matrices_to_fp8_e4m3_per_output_channel():
    sd = {"visual.blocks.0.mlp.fc1.weight": torch.randn(8, 16).bfloat16(),
          "visual.patch_embed.proj.weight": torch.randn(8, 3, 2, 2).bfloat16(),
          "visual.blocks.0.norm1.weight": torch.randn(16).bfloat16(),
          "text.token_embedding.weight": torch.randn(10, 16).bfloat16()}
    out = weights_eva_postnorm.fp8_rounded(sd, "cpu")
    for key in ("visual.blocks.0.mlp.fc1.weight", "visual.patch_embed.proj.weight"):
        w, got = sd[key].float(), out[key].float()
        scale = w.abs().amax(dim=tuple(range(1, w.dim())), keepdim=True) / 448
        codes = got / scale
        # the codes lie on the e4m3 grid (within the bf16 rounding of the
        # way back), and at most half an e4m3 step from the weights
        grid = codes.to(torch.float8_e4m3fn).float()
        assert torch.allclose(codes, grid, rtol=2 ** -7, atol=0)
        assert codes.abs().max() <= 448 * (1 + 2 ** -7)
        assert ((got - w).abs() <= w.abs() * 2 ** -4 + scale * 2 ** -9 + 1e-6).all()
        assert not torch.equal(got, sd[key])
    for key in ("visual.blocks.0.norm1.weight", "text.token_embedding.weight"):
        assert torch.equal(out[key], sd[key])


def test_sound_tiny_run_is_correct(pn_bench):
    result = _run(pn_bench)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"feature_err", "text_err", "failed_requests"}


def test_the_control_is_not_correct(pn_bench):
    result = harness.run_cell(CELL, 2 ** 31 + 13, 0.5, False, t0=time.perf_counter(),
                              device="cpu", bench=pn_bench, control=True, log=lambda line: None)
    assert not result["correct"], result["checks"]
    assert result["checks"]["feature_err"]["value"] > 1e-3


def _pre_norm_chain(x, p, n_head, ln_residual, gemm, attention):
    from protoclip_tpu_torch.ops import kernels

    d = x.shape[-1]
    h = kernels.layernorm_rows_plain(x, p["ln1s"], p["ln1b"], kernels.EVA_LN_EPS)
    qkv = gemm(h, p["wqkv"], p["bqkv"], "bias")
    attn = attention(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], n_head)
    x = gemm(attn, p["wo"], p["bo"], "bias_residual", residual=x)
    hid = gemm(kernels.layernorm_rows_plain(x, p["ln2s"], p["ln2b"], kernels.EVA_LN_EPS),
               p["wfc"], p["bfc"], "bias_gelu_erf")
    return gemm(hid, p["wproj"], p["bproj"], "bias_residual", residual=x)


def _tanh_gelu_epilogue(exact):
    def gemm(a, w, bias, epilogue, residual=None):
        if epilogue == "bias_gelu_erf":
            h = torch.matmul(a.float(), w.float()) + bias.float()
            return torch.nn.functional.gelu(h, approximate="tanh").to(a.dtype)
        return exact(a, w, bias, epilogue, residual)
    return gemm


@pytest.mark.parametrize("fault", ["a pre-norm block", "tanh gelu"])
def test_planted_faults_are_not_correct(pn_bench, monkeypatch, fault):
    from protoclip_tpu_torch.ops import kernels

    if fault == "a pre-norm block":
        monkeypatch.setattr(kernels, "_eva_postnorm_block_chain", _pre_norm_chain)
    else:
        monkeypatch.setattr(kernels, "gemm_bias_epilogue_plain",
                            _tanh_gelu_epilogue(kernels.gemm_bias_epilogue_plain))
    result = _run(pn_bench)
    assert not result["correct"], result["checks"]


def test_readers_read_nothing_where_the_program_has_nothing(pn_bench):
    """On the CPU no kernel is named in the trace and no launch counted: the
    device readers and the launch counter give None, and do not raise."""
    result = _run(pn_bench, trace=True)
    assert result["correct"]
    got = {k: m["value"] for k, m in result["metrics"].items()}
    assert "mfu.bige-bank" in got
    for name in ("postln_roofline.bige-bank", "encode_roofline.bige-bank",
                 "launches_per_block.bige-bank"):
        assert name not in got
    run = harness.Run({}, TINY_PN, {}, 0.0, {"launches": {"layernorm_residual_rows": 4,
                                                          "gemm_bias_epilogue": 8,
                                                          "gemm_bias_epilogue.bias_gelu_erf": 2,
                                                          "attention_packed": 2,
                                                          "fused_eva_postnorm_block": 2},
                                               "encode_rows": [5]}, None,
                      {"device_ops": [["void (anonymous namespace)::layernorm_residual_rows_"
                                       "kernel<__nv_bfloat16>", 1e-6]], "kernel_s": 1e-3})
    assert Bench().reader("launches_per_block.bige-bank")(run) == 7.0
    assert Bench().reader("postln_roofline.bige-bank")(run) > 0
    assert Bench().reader("encode_roofline.bige-bank")(run) > 0


def test_the_parent_program_fails_at_once(pn_bench, monkeypatch):
    """A program without the backbone raises before any weight is drawn."""
    from protoclip_tpu_torch.models import clip

    monkeypatch.delitem(clip.PORT_BACKBONE_CONFIGS, TINY_BACKBONE)
    monkeypatch.setattr(weights_eva_postnorm, "state_dict",
                        lambda *a: pytest.fail("weights drawn"))
    with pytest.raises(RuntimeError, match="has no"):
        _run(pn_bench)


def test_the_depth_factor_keeps_the_stream_and_the_softmax_soft(monkeypatch):
    """Why the post-norm LayerNorms' scales carry (2 * layers)^-0.5 (the
    configuration's ``assumed``): on a 64-block tower (width 224, 2 heads of
    112, MLP 1920, L = 257) without the factor the residual stream, which no
    LayerNorm touches, grows ~57x and the last blocks' softmaxes are nearly
    one-hot (their mean peak ~0.95); with it the stream grows ~6x and the
    mean peak stays ~0.1."""
    from benchmark import inputs
    from benchmark.reference import eva_postnorm

    cfg = dict(TINY_PN, image_resolution=224, vision_layers=64, vision_width=224,
               vision_mlp_width=1920, transformer_layers=1)
    images = inputs.split_images(7, 2, 224, "cpu")
    softmax = torch.softmax
    found = {}
    for scaled in (True, False):
        sd = weights_eva_postnorm.state_dict(cfg, 5, "cpu")
        if not scaled:
            for key in sd:
                if key.startswith("visual.blocks.") and key.endswith(("norm1.weight",
                                                                      "norm2.weight")):
                    sd[key] = sd[key].float() * (2 * 64) ** 0.5
        tower = PostnormImageTower(sd, 2, "cpu")
        rms, peaks, block = [], [], tower._block

        def recorded(x, i, block=block, tower=tower, rms=rms):
            out = block(x, i)
            if i in (0, tower.layers - 1):
                rms.append(float((x if i == 0 else out).pow(2).mean().sqrt()))
            return out

        def peaked(t, dim, peaks=peaks):
            p = softmax(t, dim=dim)
            peaks.append(float(p.amax(-1).mean()))
            return p

        tower._block = recorded
        monkeypatch.setattr(eva_postnorm.torch, "softmax", peaked)
        tower(images)
        monkeypatch.setattr(eva_postnorm.torch, "softmax", softmax)
        found[scaled] = (rms[1] / rms[0], sum(peaks[-8:]) / 8)
    assert found[True][0] < 10 and found[True][1] < 0.3, found
    assert found[False][0] > 30 and found[False][1] > 0.8, found
