"""The per-layer metrics that read the program's own spans: on the tiny
cells on the CPU, a traced run reads a positive number for each, and an
untraced run reads None."""

import time

import pytest

from benchmark import harness

METRICS = {
    "vit-b16.bank-1024": ("pad_ms.bank", "h2d_gbps.bank", "readback_ms.bank"),
    "vit-l14.scene": ("crop_preprocess_ms.scene", "issue_ms.scene", "readback_ms.scene"),
}


def _run(bench, workload, trace):
    from protoclip_tpu_torch.obs import profiler

    profiler.clear()
    return harness.run_cell(workload, 2 ** 31 + 5, 0.5, trace, t0=time.perf_counter(),
                            device="cpu", bench=bench, log=lambda line: None)


def test_the_span_metrics_are_declared():
    declared = {m["name"]: m for m in harness.Bench().spec["per_layer"]}
    for workload, names in METRICS.items():
        for name in names:
            assert declared[name]["workloads"] == [workload]
            assert declared[name]["source"] == "program_span"


@pytest.mark.parametrize("workload", sorted(METRICS))
def test_traced_runs_read_the_spans(tiny_bench, workload):
    result = _run(tiny_bench, workload, trace=True)
    assert result["correct"]
    for name in METRICS[workload]:
        assert result["metrics"][name]["value"] > 0, name
    names = {op for op, _ in result["breakdown"]["device_ops"]}
    assert not names & {"loader.pad", "encode.upload", "encode_loader.readback",
                        "classify.preprocess", "infer.issue", "infer.readback"}


def _read(name, trace):
    run = harness.Run({}, {}, {}, 0.0, {}, None, trace)
    return harness.Bench().reader(name)(run)


@pytest.mark.parametrize("workload", sorted(METRICS))
def test_untraced_runs_read_none(tiny_bench, workload):
    from protoclip_tpu_torch.obs import profiler

    assert _run(tiny_bench, workload, trace=False)["correct"]
    assert profiler.records() == []  # no profiler, no records
    for name in METRICS[workload]:
        assert _read(name, trace={"window_s": 1.0}) is None
    _run(tiny_bench, workload, trace=True)
    for name in METRICS[workload]:  # records, but of no traced run
        assert _read(name, trace=None) is None
