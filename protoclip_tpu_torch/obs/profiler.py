"""Profiling helpers (counterpart of ``protoclip_tpu/obs/profiler.py``):
wall-clock timing that waits for the card, and ``torch.profiler`` traces.

The JAX module's ``enable_compilation_cache`` has no counterpart: nothing
is compiled per shape here, and the kernels' build cache is
``ops/_build.py``'s (``build/kernels/``, rebuilt when a source changes).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


def _synchronize() -> None:
    """Wait for the card's queued work, where this process has used it."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed(label: str = "", results: dict | None = None) -> Iterator[None]:
    """Wall-clock a block, the card's work it queued included: the card is
    synchronized before the clock is read (where JAX's ``timed`` could only
    drain effect tokens)."""
    start = time.perf_counter()
    yield
    _synchronize()
    elapsed = time.perf_counter() - start
    if results is not None:
        results[label or "elapsed"] = elapsed
    if label:
        print(f"[timed] {label}: {elapsed:.3f}s")


@contextlib.contextmanager
def trace_to(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace the block with ``torch.profiler`` (CPU activities, and the
    card's where CUDA is available) and write it as a Chrome trace,
    ``log_dir/trace.json`` (Perfetto, ``chrome://tracing``).  Yields the
    profiler, whose ``key_averages()`` sum the block's time by op."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
