"""The traced run's profiler and its reduction to numbers.

``torch.profiler`` traces the host and the card over the window.  Its raw
events are read through ``kineto_results``: the ``bench.window`` range
bounds the window, the card's events (kernels, copies, sets) give the
busy time as the union of their intervals and the kernel time by name
(the method of ``chip_smoke.py::device_ms_by_kind``, kept here so that
the yardstick does not move with the program), and every stretch of the
window in which the card ran nothing is split among the
innermost ``bench.*`` spans open on the host during it.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

from benchmark.spans import PREFIX

TOP = 10
NAME_CHARS = 120
NO_SPAN = "outside the benchmark's spans"


class Tracer:
    def __init__(self, device: str):
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.startswith("cuda"):
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.cuda = device.startswith("cuda")
        self.prof = torch.profiler.profile(activities=activities)

    def __enter__(self) -> "Tracer":
        self.prof.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()
        self.prof.__exit__(*exc)

    def summary(self) -> Dict:
        from torch.autograd import DeviceType

        window, host, device = None, [], []
        for ev in self.prof.profiler.kineto_results.events():
            name = ev.name()
            if ev.device_type() == DeviceType.CPU:
                if name == PREFIX + "window":
                    window = (ev.start_ns(), ev.end_ns())
                elif name.startswith(PREFIX):
                    host.append((ev.start_ns(), ev.end_ns(), name[len(PREFIX):]))
            elif not name.startswith(PREFIX):  # the spans' mirrors on the card's timeline
                device.append((ev.start_ns(), ev.end_ns(), name))
        if window is None:
            raise RuntimeError("the trace holds no bench.window range")
        return reduce_trace(window, host, device)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


def _host_segments(host: List[Tuple[int, int, str]]) -> List[Tuple[int, int, str]]:
    """Nested spans -> non-overlapping segments labelled by the innermost
    span open in each."""
    marks = sorted([(s, 1, i) for i, (s, _, _) in enumerate(host)]
                   + [(e, 0, i) for i, (_, e, _) in enumerate(host)])
    open_spans: Dict[int, Tuple[int, str]] = {}
    segments = []
    for (t, kind, i), nxt in zip(marks, marks[1:] + [None]):
        if kind:
            s, e, name = host[i]
            open_spans[i] = (e - s, name)
        else:
            open_spans.pop(i, None)
        if nxt is not None and nxt[0] > t and open_spans:
            segments.append((t, nxt[0], min(open_spans.values())[1]))
    return segments


def _idle_by_span(gaps, segments) -> Dict[str, float]:
    """Seconds of the idle stretches under each host span; time under no
    span goes to ``NO_SPAN``."""
    starts = [seg[0] for seg in segments]
    idle: Dict[str, float] = {}
    for s, e in gaps:
        covered = 0
        i = max(0, bisect.bisect_right(starts, s) - 1)
        while i < len(segments) and segments[i][0] < e:
            a, b, label = segments[i]
            part = min(b, e) - max(a, s)
            if part > 0:
                idle[label] = idle.get(label, 0.0) + part / 1e9
                covered += part
            i += 1
        if e - s > covered:
            idle[NO_SPAN] = idle.get(NO_SPAN, 0.0) + (e - s - covered) / 1e9
    return idle


def reduce_trace(window: Tuple[int, int], host: List[Tuple[int, int, str]],
                 device: List[Tuple[int, int, str]]) -> Dict:
    """Numbers of one traced window from raw intervals in nanoseconds:
    busy and window seconds, kernel seconds (copies and sets left out), the
    longest device operations by name and the idle time by host span."""
    w0, w1 = window
    clipped = [(max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1]
    busy = _union([(s, e) for s, e, _ in clipped if e > s])
    by_name: Dict[str, float] = {}
    kernel_ns = 0
    for s, e, name in clipped:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
        if not name.startswith(("Memcpy", "Memset")):
            kernel_ns += e - s
    gaps, cursor = [], w0
    for s, e in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if cursor < w1:
        gaps.append((cursor, w1))
    host_in = [(s, e, n) for s, e, n in host if e > w0 and s < w1]
    idle = _idle_by_span(gaps, _host_segments(host_in))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "kernel_s": kernel_ns / 1e9,
        "device_ops": [[name[:NAME_CHARS], secs] for name, secs in ranked[:TOP]],
        "idle_gaps": [[label, secs] for label, secs in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]],
    }
