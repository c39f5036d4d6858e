"""Host spans the benchmark records around its calls into the program.

Each span keeps its name and its start and end on the host clock
(``time.perf_counter``).  In a traced run it is also a
``torch.profiler.record_function`` range named ``bench.<name>``, so the
device timeline can be read against what the host was doing
(``trace.py`` labels the device's idle gaps by it).  Spans inside the
program are not the benchmark's to add.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, List, Tuple

PREFIX = "bench."


class Spans:
    def __init__(self, trace: bool):
        self.trace = trace
        self.records: List[Tuple[str, float, float]] = []

    def range(self, name: str):
        """A profiler range alone (no host record), or nothing untraced."""
        if not self.trace:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(PREFIX + name)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        with self.range(name):
            start = time.perf_counter()
            try:
                yield
            finally:
                self.records.append((name, start, time.perf_counter()))

    def durations(self, name: str, since: float = float("-inf"),
                  until: float = float("inf")) -> List[float]:
        """Seconds of each ``name`` span that ended inside [since, until]."""
        return [t1 - t0 for n, t0, t1 in self.records if n == name and since <= t1 <= until]
