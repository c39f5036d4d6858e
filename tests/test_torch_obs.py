"""The port's profiling helpers (``protoclip_tpu_torch/obs/profiler.py``) on
the CPU: ``timed`` as the JAX package's, and ``trace_to``'s Chrome trace."""

import json

import numpy as np
import torch

from protoclip_tpu.obs import timed as jax_timed

from protoclip_tpu_torch.obs import timed, trace_to


def test_timed_records_and_prints_as_jax(capsys):
    results, jax_results = {}, {}
    with timed("block", results):
        _ = np.ones(10).sum()
    ours = capsys.readouterr().out
    with jax_timed("block", jax_results):
        _ = np.ones(10).sum()
    theirs = capsys.readouterr().out
    assert set(results) == set(jax_results) == {"block"} and results["block"] >= 0
    assert ours.startswith("[timed] block: ") and theirs.startswith("[timed] block: ")
    unlabelled = {}
    with timed(results=unlabelled):
        pass
    assert list(unlabelled) == ["elapsed"] and capsys.readouterr().out == ""


def test_trace_to_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with trace_to(str(log_dir)) as prof:
        a = torch.randn(64, 64)
        (a @ a).sum()
    trace = json.loads((log_dir / "trace.json").read_text())
    names = {event.get("name") for event in trace["traceEvents"]}
    assert "aten::mm" in names
    assert any(avg.key == "aten::mm" for avg in prof.key_averages())
