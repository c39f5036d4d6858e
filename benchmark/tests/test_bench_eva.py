"""The EVA02-CLIP pieces of the benchmark on the CPU: the weights' layout
against what the program's converter reads, the reference against the
tests' plain reference, the operation counts, and planted faults in the
program that make a tiny EVA02 bank cell's ``correct`` false.

The tiny cell runs in fp32 (width 128, 2 heads, 2 layers, 56 px, SwiGLU
hidden 341; text 64 wide, 1 layer) with limits of its own: sound runs read
under 1e-5 (the plain versions against the reference differ in the order
of fp32 sums), and the tanh form of the GELU moves the text features by
more than 1e-4, which no bf16 run could tell from its own rounding.
"""

import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, weights_eva, work_eva
from benchmark.harness import Bench
from benchmark.reference import eva as ref_eva

from .conftest import make_tiny_root

# the tests' plain reference and synthetic EVA-CLIP layout, by path (a
# package named ``tests`` elsewhere on the path may shadow the folder)
_spec = importlib.util.spec_from_file_location(
    "eva_reference", Path(__file__).resolve().parents[2] / "tests" / "eva_reference.py")
eva_reference = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(eva_reference)

EVA = "eva02-l14-336.bank-1024"
TINY_EVA = {
    "name": "tiny-eva", "backbone": "EVA02-CLIP-L-14-336", "source": "test", "embed_dim": 32,
    "image_resolution": 56, "vision_layers": 2, "vision_width": 128, "vision_heads": 2,
    "vision_patch_size": 14, "vision_mlp_width": 341, "vision_block": "eva02", "rope_pt_grid": 16,
    "context_length": 16, "vocab_size": 49408, "transformer_width": 64, "transformer_heads": 1,
    "transformer_layers": 1, "text_act": "gelu", "weights_dtype": "bfloat16",
    "compute_dtype": "float32", "outlier_gain": 8.0, "reduced": [], "assumed": [],
}
TINY_LIMITS = {"feature_err": 1e-5, "text_err": 1e-5}


@pytest.fixture
def eva_bench(tmp_path):
    """The tiny benchmark root with the EVA02 cell on the tiny EVA02
    configuration."""
    bench = make_tiny_root(tmp_path)
    data = bench.data
    (data / "configs" / "tiny-eva.json").write_text(json.dumps(TINY_EVA))
    (data / "cells" / f"{EVA}.json").write_text(json.dumps({"limits": TINY_LIMITS}))
    real = Bench()
    (data / "traffic" / "bank-1024-shm.json").write_text(json.dumps(
        dict(real.traffic("bank-1024-shm"), classes=3, shots=5, batch_size=8)))
    spec = bench.spec
    spec["configs"].append({"name": "tiny-eva", "source": "test", "reduced": [], "why": "CPU",
                            "file": "benchmark/configs/tiny-eva.json"})
    for w in spec["workloads"]:
        if w["name"] == EVA:
            w["config"] = "tiny-eva"
    (bench.root / "BENCHMARK.json").write_text(json.dumps(spec))
    return Bench(bench.root)


def _run(bench, trace=False):
    return harness.run_cell(EVA, 2 ** 31 + 9, 0.5, trace, t0=time.perf_counter(), device="cpu",
                            bench=bench, log=lambda line: None)


def test_layout_is_what_the_converter_reads():
    from protoclip_tpu_torch.models import clip
    sd = weights_eva.state_dict(TINY_EVA, 3, "cpu")
    tiny = dict(eva_reference.TINY, vocab=TINY_EVA["vocab_size"])
    layout = eva_reference.eva_state_dict(0, tiny, buffers=False)
    assert set(sd) == set(layout)
    for key, value in sd.items():
        assert value.shape == layout[key].shape, key
    cfg, params = clip.convert_clip_state_dict(sd)
    assert cfg.is_eva and cfg.vision_mlp_width == 341 and cfg.text_act == "gelu"
    assert params["visual"]["blocks"][1]["mlp"]["w12"].shape == (128, 688)


def test_control_rounds_every_matrix_per_channel():
    sd = weights_eva.state_dict(TINY_EVA, 4, "cpu")
    ctl = weights_eva.int8_rounded(sd)
    w, q = sd["visual.blocks.0.mlp.w3.weight"].float(), ctl["visual.blocks.0.mlp.w3.weight"].float()
    step = w.abs().amax(dim=1, keepdim=True) / 127
    # within half a step, and the value's rounding back to bf16
    assert ((w - q).abs() <= step / 2 + q.abs() * 2 ** -8).all() and not torch.equal(w, q)
    assert torch.equal(ctl["text.token_embedding.weight"], sd["text.token_embedding.weight"])
    assert torch.equal(ctl["visual.norm.weight"], sd["visual.norm.weight"])


def test_reference_matches_the_tests_reference():
    sd = weights_eva.state_dict(TINY_EVA, 5, "cpu")
    images = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (3, 56, 56, 3),
                                                                dtype=np.uint8))
    ours = ref_eva.EvaImageTower(sd, 2, 16, "cpu", block=2)(images)
    theirs = eva_reference.EvaCLIP(sd, 2, 1, 16)
    mean = torch.tensor(ref_eva.MEAN)
    std = torch.tensor(ref_eva.STD)
    torch.testing.assert_close(ours, theirs.encode_image((images / 255.0 - mean) / std),
                               rtol=1e-5, atol=1e-5)
    tokens = torch.zeros(4, 16, dtype=torch.long)
    tokens[:, 0], tokens[:, 1:5], tokens[:, 5] = 49406, torch.arange(1, 5), 49407
    torch.testing.assert_close(ref_eva.TextTower(sd, 1, "gelu", "text.", "cpu", block=3)(tokens),
                               theirs.encode_text(tokens), rtol=1e-5, atol=1e-5)
    cos, sin = ref_eva.rope_tables(24, 16, 64)
    from protoclip_tpu_torch.models.eva import rope_tables

    port_cos, port_sin = rope_tables(24, 16, 64)
    torch.testing.assert_close(cos, port_cos, rtol=0, atol=2e-6)
    torch.testing.assert_close(sin, port_sin, rtol=0, atol=2e-6)


def test_work_counts_by_hand():
    cfg = Bench().config("eva02-l14-336")
    length, d, h = 577, 1024, 2730
    block = 8 * length * d * d + 6 * length * d * h + 4 * length ** 2 * d
    flops = 2 * 576 * 588 * d + 24 * block + 2 * d * 768
    assert work_eva.image_flops(cfg) == flops
    assert flops / 1e9 == pytest.approx(381.86, abs=0.01)
    pieces = {p: (c, b, o) for p, c, b, o in work_eva.encode_pieces(cfg, 1024)}
    m = 1024 * length
    # the SwiGLU GEMM reads x and w1 | w2 and writes H; the hidden's sub-LN
    # reads and writes its true width
    assert pieces["swiglu"][1] == (m * d + d * 2 * h + 2 * h + m * h) * 2
    assert pieces["ln_ffn"][1] == 2 * m * h * 2 + 2 * h * 4
    assert pieces["qkv_rope"][2] == 2 * m * d * 3 * d + 3 * 1024 * 576 * 2 * d
    products = sum(c * o for p, c, _, o in work_eva.encode_pieces(cfg, 1024)
                   if p not in ("ln_1", "ln_inner", "ln_2", "ln_ffn", "ln_post"))
    epilogues = 24 * (3 * 1024 * 576 * 2 * d + 5 * m * h)
    assert products - epilogues == 1024 * flops


def test_sound_tiny_run_is_correct(eva_bench):
    result = _run(eva_bench)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"feature_err", "text_err", "failed_requests"}


def _rope_on_every_row(a, w, bias, cos, sin, rot_cols):
    """The QKV epilogue with the class token turned too: its table row taken
    as (t - 1) mod (L - 1), the last patch's angle (token 1's is 0)."""
    from protoclip_tpu_torch.ops import kernels

    y = (torch.matmul(a.float(), w.float()) + bias.float()).to(a.dtype)
    b, l, _ = y.shape
    dh = cos.shape[-1]
    table_c = torch.cat([cos[-1:], cos])[:, None, :]
    table_s = torch.cat([sin[-1:], sin])[:, None, :]
    q_k = y[..., :rot_cols].float().reshape(b, l, rot_cols // dh, dh)
    turned = kernels.rotate_pairs(q_k, table_c, table_s)
    y[..., :rot_cols] = turned.reshape(b, l, rot_cols).to(y.dtype)
    return y


def _ln_over_the_stride(x, scale, bias, eps=1e-6):
    """The sub-LN's statistics over the padded row (the zero lanes counted)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    w = scale.shape[0]
    y = ((xf - mean) * torch.rsqrt(var + eps))[..., :w] * scale + bias
    return torch.nn.functional.pad(y, (0, x.shape[-1] - w)).to(x.dtype)


def _tanh_gelu_epilogue(exact):
    def gemm(a, w, bias, epilogue, residual=None):
        if epilogue == "bias_gelu_erf":
            h = torch.matmul(a.float(), w.float()) + bias.float()
            return torch.nn.functional.gelu(h, approximate="tanh").to(a.dtype)
        return exact(a, w, bias, epilogue, residual)
    return gemm


@pytest.mark.parametrize("fault", ["rope on the class token", "ln_ffn over 2736 lanes",
                                   "tanh gelu in the text tower"])
def test_planted_faults_are_not_correct(eva_bench, monkeypatch, fault):
    from protoclip_tpu_torch.ops import kernels

    if fault.startswith("rope"):
        monkeypatch.setattr(kernels, "gemm_bias_rope_plain", _rope_on_every_row)
    elif fault.startswith("ln_ffn"):
        monkeypatch.setattr(kernels, "layernorm_sub_rows_plain", _ln_over_the_stride)
    else:
        monkeypatch.setattr(kernels, "gemm_bias_epilogue_plain",
                            _tanh_gelu_epilogue(kernels.gemm_bias_epilogue_plain))
    result = _run(eva_bench)
    assert not result["correct"], result["checks"]


def test_readers_read_nothing_where_the_program_has_nothing(eva_bench):
    """On the CPU no kernel is named in the trace and no launch counted: the
    device readers and the launch counter give None, and do not raise."""
    result = _run(eva_bench, trace=True)
    assert result["correct"]
    got = {k: m["value"] for k, m in result["metrics"].items()}
    assert "mfu.eva-bank" in got
    for name in ("swiglu_roofline.eva-bank", "rope_roofline.eva-bank", "subln_roofline.eva-bank",
                 "launches_per_block.eva-bank"):
        assert name not in got
    run = harness.Run({}, TINY_EVA, {}, 0.0, {"launches": {"layernorm_rows": 6,
                                                           "layernorm_sub_rows": 2,
                                                           "gemm_bias_epilogue": 8,
                                                           "gemm_bias_epilogue.bias_rope": 2,
                                                           "attention_packed": 2,
                                                           "fused_eva_block": 2},
                                                "encode_rows": [5]}, None, None)
    assert Bench().reader("launches_per_block.eva-bank")(run) == 9.0
