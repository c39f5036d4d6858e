"""A tiny copy of the benchmark for CPU tests: the real metric readers and
drivers, a 2-layer ViT of width 64 at 32 px, and each traffic mix cut to
a few rows, a few crops and a slow rate.

The tiny cells have limits of their own: two blocks of width 64 put bf16
and its W8A8 control closer together than the full towers do, so the
cells' limits (set from full-size readings on the card) do not carry
over.  Sound tiny runs read at most 0.021 (features) and 0.15 / 0.11
(probabilities, rank) over 8 seeds; a wrong answer reads 0.3 or more."""

from __future__ import annotations

import json
import shutil

import pytest

from benchmark.harness import Bench

TINY = {
    "name": "tiny", "backbone": "ViT-B/16", "source": "test", "embed_dim": 32,
    "image_resolution": 32, "vision_layers": 2, "vision_width": 64, "vision_heads": 1,
    "vision_patch_size": 16, "context_length": 77, "vocab_size": 1000,
    "transformer_width": 64, "transformer_heads": 1, "transformer_layers": 1,
    "weights_dtype": "bfloat16", "compute_dtype": "bfloat16", "outlier_gain": 8.0, "reduced": [], "assumed": [],
}
# the serving cell, also where a copy of BENCHMARK.json leaves it out
SERVE = {"name": "vit-b16.serve-encode", "config": "vit-b16", "traffic": "serve-encode",
         "chips": 1, "why": "HTTP /encode under open-loop load"}
LIMITS = {
    "vit-b16.bank-1024": {"feature_err": 0.1},
    "vit-l14.scene": {"prob_err": 0.5, "rank_gap": 0.3},
    "vit-b16.serve-encode": {"feature_err": 0.1},
}
TRAFFIC = {
    "bank-1024": {"classes": 3, "shots": 5, "batch_size": 8},
    "scene": {"classes": 6, "max_crops": 4, "crop_pool": 12, "frames": 2, "warmup_scenes": 1},
    "serve-encode": {"jpegs": 4, "batch_size": 8, "buckets": [2], "rate_per_s": 8.0,
                     "warmup_s": 0.5, "drain_s": 30.0},
}


def make_tiny_root(tmp_path):
    """A checkout-like root with BENCHMARK.json and the benchmark's data
    files, every cell on the tiny configuration."""
    real = Bench()
    data = tmp_path / "benchmark"
    shutil.copytree(real.data / "metrics", data / "metrics")
    (data / "cells").mkdir()
    for name, limits in LIMITS.items():
        (data / "cells" / f"{name}.json").write_text(json.dumps({"limits": limits}))
    (data / "configs").mkdir()
    (data / "configs" / "tiny.json").write_text(json.dumps(TINY))
    (data / "traffic").mkdir()
    for name, override in TRAFFIC.items():
        traffic = dict(real.traffic(name), **override)
        if name == "scene":
            traffic["classifier"] = dict(traffic["classifier"], shots=3)
        (data / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    spec = dict(real.spec)
    spec["configs"] = [{"name": "tiny", "source": "test", "file": "benchmark/configs/tiny.json",
                        "reduced": [], "why": "CPU tests"}]
    workloads = {w["name"]: w for w in real.spec["workloads"]}
    workloads.setdefault(SERVE["name"], SERVE)
    spec["workloads"] = [dict(w, config="tiny") for w in workloads.values()]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return Bench(tmp_path)


@pytest.fixture
def tiny_bench(tmp_path):
    return make_tiny_root(tmp_path)


@pytest.fixture
def card():
    """Skip unless a CUDA card is here (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
