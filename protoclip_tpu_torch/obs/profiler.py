"""Profiling helpers (counterpart of ``protoclip_tpu/obs/profiler.py``):
wall-clock timing that waits for the card, ``torch.profiler`` traces, and
the program's own spans.

The JAX module's ``enable_compilation_cache`` has no counterpart: nothing
is compiled per shape here, and the kernels' build cache is
``ops/_build.py``'s (``build/kernels/``, rebuilt when a source changes).

**Spans.** ``with span(name, rows=..., nbytes=...):`` marks where a layer
of the program does its work (the padded batch, an upload, a read-back,
a server's parse).  Every span always adds its count, nanoseconds, rows
and bytes to a process-wide table keyed by ``(name, label)`` (``totals()``;
the server's ``/statz`` and ``/metrics`` read it, labelled by route).
While a ``torch.profiler`` records anywhere in the process (``trace_to``,
or any traced window), the span also keeps one record (``records()``):
its start and end on the profiler's clock (the epoch clock of
``time.time_ns``, which the profiler's host events use), rows, bytes, its
id, the id of the span open around it on the same thread and a request id
that every span of one scene, batch or HTTP request shares
(:class:`request`).  So a record lies on the same time axis as the card's
kernels in the same trace.

A span never opens a ``torch.profiler.record_function`` range: a range
that encloses kernel launches gets a mirror on the card's timeline,
stretching from its first kernel to its last, gaps included, which a
trace reader would count as device work.  Spans stay on the host.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
import weakref
from typing import Dict, Iterator, List, NamedTuple, Tuple

import torch

# its ``_is_profiler_enabled`` is set while any torch profiler records, for
# every thread of the process (``torch.autograd._profiler_enabled()`` answers
# for the calling thread alone, and costs a call)
_autograd_profiler = torch.autograd.profiler
_now = time.perf_counter_ns


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


class SpanRecord(NamedTuple):
    """One span kept while a profiler recorded.  ``start_ns``/``end_ns``
    are on the epoch clock; ``parent`` is 0 for a span with none open
    around it on its thread."""

    name: str
    label: str
    start_ns: int
    end_ns: int
    rows: int
    nbytes: int
    id: int
    parent: int
    request: int
    thread: int


class _Retired:
    """Held by one thread's state alone: freed when the thread ends."""


class _Local(threading.local):
    label = ""
    request = 0

    def __init__(self):
        self.stack: List["span"] = []  # recorded spans open on this thread
        # this thread's part of the table, written by this thread alone:
        # the hot path takes no lock; a finished thread's part is folded
        # into _retired
        self.acc: Dict[Tuple[str, str], List[int]] = {}
        self.token = _Retired()
        with _lock:
            _live[id(self.acc)] = self.acc
        weakref.finalize(self.token, _retire, self.acc)


_lock = threading.RLock()  # a finished thread's part may fold in while it is held
_live: Dict[int, Dict[Tuple[str, str], List[int]]] = {}  # each thread's table
_retired: Dict[Tuple[str, str], List[int]] = {}  # (name, label) -> [count, ns, rows, bytes]
_ids = itertools.count(1)
_records: List[SpanRecord] = []


def _add_into(table: dict, key: Tuple[str, str], entry) -> None:
    total = table.setdefault(key, [0, 0, 0, 0])
    for i in range(4):
        total[i] += entry[i]


def _retire(acc: dict) -> None:
    with _lock:
        for key, entry in list(acc.items()):
            _add_into(_retired, key, entry)
        _live.pop(id(acc), None)


_local = _Local()


def _count(key: Tuple[str, str], ns: int, rows: int, nbytes: int) -> None:
    acc = _local.acc
    try:
        entry = acc[key]
    except KeyError:
        entry = acc[key] = [0, 0, 0, 0]
    entry[0] += 1
    entry[1] += ns
    entry[2] += rows
    entry[3] += nbytes


class request:
    """Every span this thread opens inside the block shares one request id
    and takes ``label`` (the server's route); outside one, the label is
    ""."""

    __slots__ = ("label", "id", "_saved")

    def __init__(self, label: str = ""):
        self.label = label

    def __enter__(self) -> "request":
        local = _local
        self._saved = (local.label, local.request)
        self.id = local.request = next(_ids)
        local.label = self.label
        return self

    def __exit__(self, *exc) -> None:
        _local.label, _local.request = self._saved


def current_request() -> int:
    """The id of the :class:`request` open on this thread; 0 outside one."""
    return _local.request


class span:
    """Count (and, while a profiler records, keep) one stretch of the
    program's work; see the module's docstring.  ``rows`` and ``nbytes``
    may be set on the object inside the block; after it, ``ns`` holds the
    span's duration and ``t0`` its start on ``time.perf_counter_ns``."""

    __slots__ = ("name", "rows", "nbytes", "id", "parent", "request", "start_ns", "t0", "ns")

    def __init__(self, name: str, rows: int = 0, nbytes: int = 0):
        self.name = name
        self.rows = rows
        self.nbytes = nbytes

    def __enter__(self) -> "span":
        if _autograd_profiler._is_profiler_enabled:
            self._open()
        else:
            self.id = 0
        self.t0 = _now()
        return self

    def _open(self) -> None:
        """Start this span's record: its id, parent and request."""
        local = _local
        stack = local.stack
        self.id = next(_ids)
        if stack:
            self.parent, self.request = stack[-1].id, stack[-1].request
        else:
            self.parent, self.request = 0, local.request or self.id
        stack.append(self)
        self.start_ns = time.time_ns()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.ns = ns = _now() - self.t0
        local = _local
        label = local.label
        acc = local.acc  # _count's body, inline: it is most of a span's cost
        key = (self.name, label)
        try:
            entry = acc[key]
        except KeyError:
            entry = acc[key] = [0, 0, 0, 0]
        entry[0] += 1
        entry[1] += ns
        entry[2] += self.rows
        entry[3] += self.nbytes
        if self.id:
            local.stack.remove(self)
            _records.append(SpanRecord(self.name, label, self.start_ns, self.start_ns + ns,
                                       self.rows, self.nbytes, self.id, self.parent,
                                       self.request, threading.get_ident()))


def add(name: str, start: int, end: int, rows: int = 0, nbytes: int = 0, request: int = 0,
        parent: int = 0) -> None:
    """A span measured elsewhere, from ``start`` to ``end`` on
    ``time.perf_counter_ns``: one that begins on one thread and ends on
    another (a request's wait in a queue), under ``request``'s id.
    Counted always, under this thread's label, and kept as a record while
    a profiler records, like :class:`span`."""
    label = _local.label
    _count((name, label), end - start, rows, nbytes)
    if _autograd_profiler._is_profiler_enabled:
        epoch = time.time_ns() - _now()
        _records.append(SpanRecord(name, label, start + epoch, end + epoch, rows, nbytes,
                                   next(_ids), parent, request, threading.get_ident()))


def records() -> List[SpanRecord]:
    """The spans kept since the last :func:`clear`, in the order they ended."""
    return list(_records)


def totals() -> Dict[Tuple[str, str], Tuple[int, int, int, int]]:
    """``(name, label) -> (count, ns, rows, bytes)`` of every span closed
    since the process started (or the last ``clear()``), every thread's."""
    with _lock:
        table = {key: list(entry) for key, entry in _retired.items()}
        for acc in list(_live.values()):
            for key, entry in list(acc.items()):
                _add_into(table, key, entry)
    return {key: tuple(entry) for key, entry in table.items()}


def clear(totals: bool = True) -> None:
    """Drop the records and, with ``totals``, the table."""
    _records.clear()
    if totals:
        with _lock:
            _retired.clear()
            for acc in list(_live.values()):
                acc.clear()


def _chrome_events(base_ns: int) -> List[dict]:
    """The records as complete events on a track of their own, ``ts`` in
    microseconds from the trace's ``baseTimeNanoseconds``."""
    pid = "protoclip spans"
    events = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
               "args": {"name": pid}}]
    for r in records():
        events.append({"ph": "X", "cat": "span", "name": r.name, "pid": pid, "tid": r.thread,
                       "ts": (r.start_ns - base_ns) / 1e3, "dur": (r.end_ns - r.start_ns) / 1e3,
                       "args": {"id": r.id, "parent": r.parent, "request": r.request,
                                "label": r.label, "rows": r.rows, "bytes": r.nbytes}})
    return events


@contextlib.contextmanager
def trace_to(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace the block with ``torch.profiler`` (CPU activities, and the
    card's where CUDA is available) and write it as a Chrome trace,
    ``log_dir/trace.json`` (Perfetto, ``chrome://tracing``), with the
    program's spans of the block, from every thread, on a track of their
    own.  Yields the profiler, whose ``key_averages()`` sum the block's
    time by op."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    clear(totals=False)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        trace = json.load(fh)
    trace["traceEvents"].extend(_chrome_events(int(trace.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as fh:
        json.dump(trace, fh)
