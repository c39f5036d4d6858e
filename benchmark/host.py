"""What the host did around a window, for an earlier stderr line of a run
(never a metric): the CPUs the process may use, the interpreter's
threads, its garbage-collector pauses, how late a 10 ms sleeper woke
(starvation of the interpreter lock or of the CPUs), the cgroup's CPU
throttling and the share of the host's CPU time stolen by its hypervisor
(in all and in each 5 s), so that runs that spread can be told apart by
their host.
"""

from __future__ import annotations

import gc
import os
import threading
import time
from pathlib import Path
from typing import Dict, List

CGROUP = Path("/sys/fs/cgroup")
TICK_S = 0.01
SLICE_S = 5.0


def facts() -> Dict:
    """The process's CPUs and thread settings."""
    import torch

    quota = CGROUP / "cpu.max"
    return {"cpu_count": os.cpu_count(), "affinity": len(os.sched_getaffinity(0)),
            "torch_threads": torch.get_num_threads(),
            "cpu_max": quota.read_text().strip() if quota.exists() else None}


def _throttled() -> Dict[str, int]:
    stat = CGROUP / "cpu.stat"
    if not stat.exists():
        return {}
    pairs = (line.split() for line in stat.read_text().splitlines())
    return {k: int(v) for k, v in pairs if k in ("nr_throttled", "throttled_usec")}


def _cpu_ticks() -> List[int]:
    """The host's CPU time in ticks: all of it and the stolen part."""
    fields = [int(v) for v in Path("/proc/stat").read_text().split("\n", 1)[0].split()[1:]]
    return [sum(fields[:8]), fields[7] if len(fields) > 7 else 0]


def _steal_pct(a: List[int], b: List[int]) -> float:
    return round(100.0 * (b[1] - a[1]) / max(1, b[0] - a[0]), 2)


class Probe:
    """Watches the host from ``start()`` to ``stop()``."""

    def start(self) -> None:
        self.gc_pauses, self._gc_t0 = [], 0.0
        self.threads_max, self.late_max, self.late_sum, self.ticks = 0, 0.0, 0.0, 0
        self._throttled0 = _throttled()
        self._cpu0 = self._cpu_last = _cpu_ticks()
        self.steal_by_slice: List[float] = []
        gc.callbacks.append(self._on_gc)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def _on_gc(self, phase, info) -> None:
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        else:
            self.gc_pauses.append((info["generation"], time.perf_counter() - self._gc_t0))

    def _watch(self) -> None:
        next_slice = time.perf_counter() + SLICE_S
        while not self._stop.is_set():
            if time.perf_counter() >= next_slice:
                now = _cpu_ticks()
                self.steal_by_slice.append(_steal_pct(self._cpu_last, now))
                self._cpu_last, next_slice = now, next_slice + SLICE_S
            t = time.perf_counter()
            time.sleep(TICK_S)
            late = time.perf_counter() - t - TICK_S
            self.late_max, self.late_sum = max(self.late_max, late), self.late_sum + late
            self.ticks += 1
            self.threads_max = max(self.threads_max, threading.active_count())

    def stop(self) -> Dict:
        self._stop.set()
        self._thread.join()
        gc.callbacks.remove(self._on_gc)
        after = _throttled()
        full = [s for g, s in self.gc_pauses if g == 2]
        return {"threads_max": self.threads_max,
                "sleeper_late_ms_mean": 1e3 * self.late_sum / max(1, self.ticks),
                "sleeper_late_ms_max": 1e3 * self.late_max,
                "gc_collections": len(self.gc_pauses),
                "gc_pause_ms_sum": 1e3 * sum(s for _, s in self.gc_pauses),
                "gc_pause_ms_max": 1e3 * max((s for _, s in self.gc_pauses), default=0.0),
                "gc_full": len(full),
                "throttled": {k: after[k] - self._throttled0.get(k, 0) for k in after},
                "steal_pct": _steal_pct(self._cpu0, _cpu_ticks()),
                "steal_pct_by_5s": self.steal_by_slice}
