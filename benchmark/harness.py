"""Find a cell's pieces by name, run it once and build its result line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix.  The harness reads, under the
benchmark's folder (``paths[0]``):

- ``configs/<config>.json`` through the configuration's ``file``;
- ``traffic/<traffic>.json``, whose ``driver`` names a module of
  ``benchmark.drivers`` that sets the program up, runs the window and
  compares what it produced with the plain reference;
- ``cells/<workload>.json``, the limits of the numbers compared;
- ``metrics/<metric>.py`` for every metric the cell reports, each with a
  ``read(run)`` that returns a number or None (nothing to read).

So a cell, a traffic mix, a configuration or a metric is added as files
alone.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from benchmark.spans import Spans

ROOT = Path(__file__).resolve().parents[1]
# top-level module names that no run may hold once its window has closed,
# compared whole: the port's own name begins with the JAX package's
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "protoclip_tpu")


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files it names."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.data = self.root / self.spec["paths"][0]

    def workload(self, name: str) -> dict:
        for entry in self.spec["workloads"]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for entry in self.spec["configs"]:
            if entry["name"] == name:
                return json.loads((self.root / entry["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.data / "traffic" / f"{name}.json").read_text())

    def cell(self, name: str) -> dict:
        return json.loads((self.data / "cells" / f"{name}.json").read_text())

    def metrics(self, workload: str, trace: bool) -> List[dict]:
        """The metrics the cell reports: its end-to-end metrics, or with
        ``trace`` its per-layer ones; an entry without ``workloads`` holds
        for every cell."""
        entries = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in entries if workload in m.get("workloads", [workload])]

    def reader(self, metric: str) -> Callable[["Run"], Optional[float]]:
        path = self.data / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


class Window:
    """The measured window: its host times and, when tracing, a
    ``bench.window`` range in the profiler's timeline."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.t_open: Optional[float] = None
        self.t_close: Optional[float] = None
        self._range = None

    def open(self) -> None:
        self._range = self.spans.range("window")
        self._range.__enter__()
        self.t_open = time.perf_counter()

    def close(self) -> None:
        self.t_close = time.perf_counter()
        self._range.__exit__(None, None, None)

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open


@dataclasses.dataclass
class Context:
    """What a driver is given: the cell's files, the run's arguments, a
    scratch directory under ``$TMPDIR`` and the host spans."""

    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    control: bool
    tmp: Path
    spans: Spans
    window: Window


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    workload: dict
    config: dict
    traffic: dict
    setup_s: float
    counters: Dict[str, Any]
    spans: Spans
    trace: Optional[Dict[str, Any]]


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES)


def _device_info(device: str, chips: int, trace: Optional[dict]) -> dict:
    import torch

    info = {"platform": "gpu" if device.startswith("cuda") else "cpu",
            "kind": torch.cuda.get_device_name(0) if device.startswith("cuda") else "cpu",
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))
            if device.startswith("cuda") else 0}
    if trace is not None:
        info["busy_s"] = trace["busy_s"]
        info["window_s"] = trace["window_s"]
    return info


def _release_device(device: str) -> None:
    gc.collect()
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()
        torch.cuda.empty_cache()


@contextlib.contextmanager
def context(bench: "Bench", workload: str, seed: int, seconds: float, trace: bool,
            device: str, control: bool):
    """The driver's context, with a scratch directory removed after."""
    entry = bench.workload(workload)
    spans = Spans(trace)
    tmp = Path(tempfile.mkdtemp(prefix="benchmark-"))
    try:
        yield Context(entry, bench.config(entry["config"]), bench.traffic(entry["traffic"]),
                      int(seed), float(seconds), bool(trace), device, bool(control), tmp, spans,
                      Window(spans))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, t0: float,
             device: str = "cuda", control: bool = False, bench: Optional[Bench] = None,
             log: Callable[[str], None] = lambda s: print(s, file=sys.stderr, flush=True)
             ) -> dict:
    """Run one cell once: set up, measure, read the peak memory, free the
    program, compare with the reference.  Returns the result line's
    object; ``t0`` is the process's start on the host clock."""
    from benchmark import trace as tracing

    bench = bench or Bench()
    limits = bench.cell(workload)["limits"]
    with context(bench, workload, seed, seconds, trace, device, control) as ctx:
        driver = importlib.import_module(f"benchmark.drivers.{ctx.traffic['driver']}").Driver(ctx)
        try:
            with (tracing.Tracer(device) if trace else contextlib.nullcontext()) as tracer:
                counters = driver.measure()
            summary = tracer.summary() if trace else None
            device_info = _device_info(device, ctx.workload["chips"], summary)
            found = forbidden_modules()
            if found:
                raise RuntimeError(f"modules of JAX or the JAX package were loaded: {found}")
        finally:
            driver.release()
            _release_device(device)
        for line in counters.pop("log", []):
            log(line)
        checks = driver.check()

    run = Run(ctx.workload, ctx.config, ctx.traffic, ctx.window.t_open - t0, counters,
              ctx.spans, summary)
    metrics = {}
    for m in bench.metrics(workload, trace):
        value = bench.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    failed = int(counters.get("failed", 0))
    compared = {name: {"value": float(value), "limit": float(limits[name])}
                for name, value in checks.items()}
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in compared.values())
    result = {"correct": correct, "attempted": int(counters["attempted"]), "failed": failed,
              "metrics": metrics, "device": device_info}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = dict(compared, failed_requests={"value": failed, "limit": 0})
    return result


def check_lines(result: dict) -> List[str]:
    """The numbers compared, each beside its limit, one a line."""
    return [f"check {name} {c['value']!r} limit {c['limit']!r}"
            for name, c in result["checks"].items()]

