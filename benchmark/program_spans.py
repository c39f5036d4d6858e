"""Readings of the program's own spans (``protoclip_tpu_torch.obs.profiler``).

The program keeps a record of each span while a ``torch.profiler``
records: in a run, the traced window's profiler.  A run is one cell in
one process, so the process's records are the window's.  A
program without spans, or an untraced run, gives nothing to read: each
reading is then None.
"""

from __future__ import annotations

from typing import List, Optional


def records(run, name: str) -> List:
    """The records of the spans ``name``, or none where the run was not
    traced or the program keeps no records."""
    if run.trace is None:
        return []
    try:
        from protoclip_tpu_torch.obs import profiler
    except ImportError:
        return []
    read = getattr(profiler, "records", None)
    return [r for r in read() if r.name == name] if read is not None else []


def mean_ms(run, name: str) -> Optional[float]:
    """Mean duration of a ``name`` span, ms."""
    spans = records(run, name)
    return 1e-6 * sum(r.end_ns - r.start_ns for r in spans) / len(spans) if spans else None


def ms_per_row(run, name: str) -> Optional[float]:
    """All ``name`` spans' time over all their rows, ms a row."""
    spans = records(run, name)
    rows = sum(r.rows for r in spans)
    return 1e-6 * sum(r.end_ns - r.start_ns for r in spans) / rows if rows else None


def gb_per_s(run, name: str) -> Optional[float]:
    """All ``name`` spans' bytes over their time, GB/s (bytes a ns)."""
    spans = records(run, name)
    ns = sum(r.end_ns - r.start_ns for r in spans)
    return sum(r.nbytes for r in spans) / ns if ns else None
