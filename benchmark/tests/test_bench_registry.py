"""BENCHMARK.json keeps to its contract, the harness finds every piece by
name, and a cell, a traffic mix, a configuration and a metric are added
as files alone."""

import json
import re
import time

import pytest

from benchmark import harness
from benchmark.harness import ROOT, Bench

from .conftest import TINY

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return Bench()


def test_top_level_shape(bench):
    spec = bench.spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(spec["command"]) <= 32 and all(TEXT.match(w) for w in spec["command"])
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 runs a cell, each with 60 s more,
    # 2 x 90 s a cell to compile, 1200 s spare, in 43200 s
    cells = 24
    assert (2 + 14 * cells) * (spec["run_seconds"] + 60) + cells * 180 + 1200 <= 43200


def test_entries(bench):
    spec = bench.spec
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in spec[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads"):
        assert len({e["name"] for e in spec[key]}) == len(spec[key])
    metrics = spec["end_to_end"] + spec["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    files = [c["file"] for c in spec["configs"]]
    assert len(set(files)) == len(files)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(spec["paths"][0] + "/") and TEXT.match(c["why"])
        assert c["reduced"] == bench.config(c["name"])["reduced"]
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT.match(w["why"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        bench.config(w["config"])
        assert bench.traffic(w["traffic"])["driver"]
        assert bench.cell(w["name"])["limits"]
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= max(1, len(spec["workloads"]) // 4)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (bench.data / "metrics" / f"{m['name']}.py").is_file()
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    setup = next(m for m in spec["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25 and "workloads" not in setup
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"]) and m["moves"] in e2e
        for w in m["workloads"]:
            assert m["moves"] in {x["name"] for x in bench.metrics(w, trace=False)}


def test_every_cell_reports_enough(bench):
    for w in bench.spec["workloads"]:
        e2e = {m["name"] for m in bench.metrics(w["name"], trace=False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert bench.metrics(w["name"], trace=True)


def test_a_new_cell_traffic_config_and_metric_are_files_alone(tiny_bench):
    data = tiny_bench.data
    (data / "configs" / "tiny-wide.json").write_text(json.dumps(dict(TINY, name="tiny-wide",
                                                                     vision_width=128,
                                                                     vision_heads=2)))
    (data / "traffic" / "bank-tiny.json").write_text(json.dumps(
        {"driver": "bank", "why": "a test mix", "classes": 2, "shots": 3, "batch_size": 4}))
    (data / "cells" / "tiny-wide.bank-tiny.json").write_text(
        json.dumps({"limits": {"feature_err": 0.05}}))
    (data / "metrics" / "rows_handed.dummy.py").write_text(
        "def read(run):\n    return float(sum(run.counters['encode_rows']))\n")
    spec = tiny_bench.spec
    spec["configs"].append({"name": "tiny-wide", "source": "test", "reduced": [], "why": "test",
                            "file": "benchmark/configs/tiny-wide.json"})
    spec["workloads"].append({"name": "tiny-wide.bank-tiny", "config": "tiny-wide",
                              "traffic": "bank-tiny", "chips": 1, "why": "test"})
    spec["end_to_end"][0]["workloads"].append("tiny-wide.bank-tiny")
    spec["per_layer"].append({"name": "rows_handed.dummy", "unit": "rows", "better": "higher",
                              "source": "program_counter", "layer": "test",
                              "moves": spec["end_to_end"][0]["name"],
                              "workloads": ["tiny-wide.bank-tiny"]})
    (tiny_bench.root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Bench(tiny_bench.root)
    result = harness.run_cell("tiny-wide.bank-tiny", 5, 0.5, True, t0=time.perf_counter(),
                              device="cpu", bench=bench)
    assert result["correct"]
    # the per-layer metrics of the other cells list their cells
    assert set(result["metrics"]) == {"rows_handed.dummy"}
    assert result["metrics"]["rows_handed.dummy"]["value"] % 8 == 0  # two batches of 4 a pass
