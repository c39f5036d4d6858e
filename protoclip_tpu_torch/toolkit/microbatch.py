"""Dynamic request micro-batching for the serving path (counterpart of
``protoclip_tpu/toolkit/microbatch.py``, numpy only but for its spans,
copied with its behaviour: FIFO all-or-nothing admission, the fill window, failure
accounting and the release of a failed request's rows, the health probe
and the statistics).

Every device dispatch pays a fixed cost on the host (on the card, the
launches of one encode), and a serving bucket runs a fixed-size batch, so a
1-image request pays its bucket's compute anyway.  Under concurrent load
the best schedule is to coalesce many small requests into one device
batch.  CLIP image features are per-image independent (LayerNorm and
attention act within an image's own tokens), so coalescing does not change
a row: ``tests/test_torch_serve.py`` asserts that.

``MicroBatcher`` owns the only thread that calls the device function (the
dispatcher); callers (HTTP handler threads) block in :meth:`submit` until
their slice of the results is ready.  The device function sets the device
its work runs on, so the dispatcher thread needs no CUDA state of its own.
Requests larger than the batch are split across consecutive dispatches.

Spans (``obs.profiler``, labelled with the batcher's ``label``):
``batch.dispatch`` (rows: the fill) around each call of the device
function, and ``batch.queue_wait`` (rows: the request's) from a request's
enqueue to the dispatch that takes its first rows, which that dispatch's
thread records under the caller's request id.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np

from protoclip_tpu_torch.obs import profiler


class _Request:
    __slots__ = ("images", "parts", "done", "error", "event", "request", "enqueued")

    def __init__(self, images: np.ndarray):
        self.images = images
        self.parts: list = []  # result slices, in submission order
        self.done = 0
        self.error: Optional[BaseException] = None
        self.event = threading.Event()
        self.request = profiler.current_request()
        self.enqueued = 0  # perf_counter_ns at the enqueue


class MicroBatcher:
    """Coalesce concurrent requests into fixed-size device batches.

    Parameters
    ----------
    run_batch:
        ``(batch_size, *item_shape) -> (batch_size, ...)`` device function
        (e.g. a loaded serving bundle).  Called only from the dispatcher
        thread, so one thread of the process issues the device work.
    batch_size:
        the device batch size; every dispatch sends exactly this many
        rows (zero-padded when underfull).
    item_shape / dtype:
        per-item input geometry, used to allocate the padded block.
    max_wait_s:
        after the first queued item, how long to wait for more work before
        dispatching an underfull batch.  0 = dispatch whatever is queued.
    max_pending:
        backpressure cap on queued images; :meth:`submit` blocks once the
        cap is reached and rejects single requests larger than it.
    trim_underfull:
        pass ``block[:fill]`` instead of the zero-padded full block when a
        dispatch is underfull.  Only for ``run_batch`` callables that
        accept variable batch sizes — e.g. a bucketed serving bundle
        (``io/export.py`` ``batch_sizes``), which pads to its smallest
        bucket so small dispatches cost less compute.  Leave False for
        callables that take one fixed shape.
    label:
        the label of the batcher's spans (the server's route).
    """

    def __init__(
        self,
        run_batch: Callable[[np.ndarray], Sequence],
        batch_size: int,
        item_shape: tuple,
        dtype=np.uint8,
        max_wait_s: float = 0.005,
        max_pending: Optional[int] = None,
        trim_underfull: bool = False,
        label: str = "",
    ):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self._run_batch = run_batch
        self.batch_size = int(batch_size)
        self.item_shape = tuple(item_shape)
        self.dtype = np.dtype(dtype)
        self.max_wait_s = float(max_wait_s)
        self.trim_underfull = bool(trim_underfull)
        self.label = label
        self.max_pending = int(max_pending or max(8 * batch_size, 1024))
        self._q: queue.Queue = queue.Queue()
        # backpressure counter. A Condition (not a Semaphore) because a
        # request's tokens must be acquired ATOMICALLY: with one-at-a-time
        # semaphore acquires, two concurrent large submits can interleave
        # (each holding half the capacity, each blocked on the next token,
        # neither enqueued) and deadlock the whole server.  Admission is
        # FIFO (_cap_waiters): without an ordering, a large submit waiting
        # for n tokens could starve forever behind a stream of small
        # submits that keep grabbing freed capacity first.
        self._cap = threading.Condition()
        self._available = self.max_pending
        self._cap_waiters: collections.deque = collections.deque()
        self._closed = False
        # orders enqueues against the close sentinel: nothing may be
        # queued after it (the dispatcher thread exits once it drains)
        self._submit_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._dispatches = 0
        self._images = 0
        # failure detection: total failed dispatches, the current failure
        # streak (reset by any success), and the last error string —
        # feeds /healthz degradation and /metrics
        self._failures = 0
        self._consecutive_failures = 0
        self._last_error: str = ""
        self._last_probe = float("-inf")
        # ring of recent per-dispatch wall times for the latency quantiles
        self._recent_s: collections.deque = collections.deque(maxlen=256)
        self._thread = threading.Thread(
            target=self._loop, name="microbatch-dispatch", daemon=True
        )
        self._thread.start()

    # -- caller side ----------------------------------------------------

    def submit(self, images: np.ndarray) -> np.ndarray:
        """Encode ``(n, *item_shape)`` items; returns the ``(n, ...)``
        results.  Blocks until this request's rows have been dispatched
        (possibly coalesced with other callers' rows)."""
        images = np.asarray(images)
        if images.dtype != self.dtype:
            # reject rather than coerce, mirroring the bundle wrapper
            # (io/export.py): silently casting float [0,1] pixels to uint8
            # would truncate them to zeros and serve garbage features
            raise ValueError(
                f"expected {self.dtype.name} input, got {images.dtype.name}"
            )
        if images.ndim != 1 + len(self.item_shape) or images.shape[1:] != self.item_shape:
            raise ValueError(
                f"expected (n, {', '.join(map(str, self.item_shape))}) "
                f"{self.dtype.name} input, got {images.shape} {images.dtype.name}"
            )
        if len(images) == 0:
            raise ValueError("empty request")
        if len(images) > self.max_pending:
            raise ValueError(
                f"request of {len(images)} images exceeds the queue cap "
                f"({self.max_pending})"
            )
        n = len(images)
        with self._cap:  # backpressure: block until ALL n tokens fit at once
            ticket = object()
            self._cap_waiters.append(ticket)
            try:
                while not self._closed and not (
                    self._cap_waiters[0] is ticket and self._available >= n
                ):
                    self._cap.wait()
                if self._closed:
                    raise RuntimeError("MicroBatcher is closed")
                self._available -= n
            finally:
                self._cap_waiters.remove(ticket)
                self._cap.notify_all()  # the next ticket holder re-checks
        req = _Request(images)
        rejected = False
        with self._submit_lock:
            if self._closed:
                # return our tokens so other submitters blocked on
                # backpressure can also drain through the closed check
                rejected = True
            else:
                req.enqueued = time.perf_counter_ns()
                self._q.put(req)
        if rejected:
            self._release_capacity(n)
            raise RuntimeError("MicroBatcher is closed")
        req.event.wait()
        if req.error is not None:
            raise req.error
        if len(req.parts) == 1:
            return req.parts[0]
        return np.concatenate(req.parts, axis=0)

    def close(self) -> None:
        """Flush queued work, then stop the dispatcher thread."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        with self._cap:
            # wake submitters stuck on backpressure: they re-check
            # _closed under the condition and raise instead of enqueueing
            self._cap.notify_all()
        self._thread.join()

    def _release_capacity(self, n: int) -> None:
        if n <= 0:
            return
        with self._cap:
            self._available += n
            self._cap.notify_all()

    @property
    def stats(self) -> dict:
        with self._stats_lock:
            d, n = self._dispatches, self._images
            recent = list(self._recent_s)
            failures = self._failures
            consecutive = self._consecutive_failures
            last_error = self._last_error
        out = {
            "dispatches": d,
            "images": n,
            "mean_fill": (n / d) if d else 0.0,
            "batch_size": self.batch_size,
            "failures": failures,
            "consecutive_failures": consecutive,
        }
        if last_error:
            out["last_error"] = last_error
        if recent:  # dispatch-latency quantiles over the last <=256 calls
            q = sorted(recent)
            out["dispatch_ms_p50"] = round(1e3 * q[len(q) // 2], 2)
            out["dispatch_ms_p99"] = round(1e3 * q[min(len(q) - 1, int(len(q) * 0.99))], 2)
            out["dispatch_ms_max"] = round(1e3 * q[-1], 2)
        return out

    def health_probe(self, min_interval_s: float = 10.0) -> bool:
        """During a failure streak, try ONE tiny dispatch so a degraded
        replica can self-recover: a load balancer that pulled the replica
        on a 503 /healthz keeps sending only health checks — with no POST
        traffic, no dispatch could ever succeed and reset the streak.
        Rate-limited to one probe per ``min_interval_s`` across callers.
        Returns True when the batcher is healthy (no streak, or the probe
        dispatch just succeeded)."""
        with self._stats_lock:
            if self._consecutive_failures == 0:
                return True
            now = time.monotonic()
            if now - self._last_probe < min_interval_s:
                return False
            self._last_probe = now
        try:
            self.submit(np.zeros((1,) + tuple(self.item_shape), self.dtype))
            return True
        except Exception:  # noqa: BLE001 — still degraded
            # KeyboardInterrupt/SystemExit must propagate, not be read as
            # "probe failed" — a Ctrl-C during a probe is a shutdown request
            return False

    # -- dispatcher side ------------------------------------------------

    def _loop(self) -> None:
        pending: collections.deque = collections.deque()  # [request, consumed]
        closing = False
        while not (closing and not pending):
            if not pending:
                req = self._q.get()
                if req is None:
                    break
                pending.append([req, 0])
            if not closing:
                closing = self._fill_window(pending)
            self._dispatch_one(pending)
        # drain anything that raced in after close()
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                req.error = RuntimeError("MicroBatcher closed")
                req.event.set()

    def _fill_window(self, pending: collections.deque) -> bool:
        """Wait up to ``max_wait_s`` for enough work to fill one batch.
        Returns True if the close sentinel was seen."""
        deadline = time.monotonic() + self.max_wait_s
        avail = sum(len(r.images) - c for r, c in pending)
        while avail < self.batch_size:
            # Already-queued work is free to take regardless of the deadline:
            # with max_wait_s=0 the timed branch below never runs, and without
            # this get_nowait() pass a burst sitting in the queue would be
            # dispatched one-request-per-batch — the documented "0 = dispatch
            # whatever is queued" contract coalesces it instead.
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    req = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
            if req is None:
                return True
            pending.append([req, 0])
            avail += len(req.images)
        return False

    def _dispatch_one(self, pending: collections.deque) -> None:
        block = np.zeros((self.batch_size,) + self.item_shape, self.dtype)
        parts = []  # (request, block_offset, n)
        first = []  # requests whose first rows this dispatch takes
        fill = 0
        while pending and fill < self.batch_size:
            entry = pending[0]
            req, consumed = entry
            n = min(len(req.images) - consumed, self.batch_size - fill)
            block[fill : fill + n] = req.images[consumed : consumed + n]
            parts.append((req, fill, n))
            if consumed == 0:
                first.append(req)
            entry[1] += n
            fill += n
            if entry[1] == len(req.images):
                pending.popleft()
        dropped_rows = 0
        if self.trim_underfull and fill < self.batch_size:
            block = block[:fill]
        try:
            out, dispatch_ns = self._run_spanned(block, fill, first)
        except BaseException as exc:  # noqa: BLE001 — fail the requests, not the loop
            failed = set()
            for req, _, _ in parts:
                if id(req) not in failed:
                    failed.add(id(req))
                    req.error = exc
                    req.event.set()
            # a partially-consumed (failed) request may still head the queue;
            # its UNCONSUMED rows hold capacity tokens from submit() too —
            # release them below or every failed over-batch request shrinks
            # the effective queue cap until submit() blocks forever
            if pending and id(pending[0][0]) in failed:
                head_req, head_consumed = pending.popleft()
                dropped_rows = len(head_req.images) - head_consumed
            with self._stats_lock:
                self._failures += 1
                self._consecutive_failures += 1
                self._last_error = f"{type(exc).__name__}: {exc}"
        else:
            # counted before any reply is released: a stats() read right
            # after a reply sees the dispatch that answered it
            with self._stats_lock:
                self._dispatches += 1
                self._images += fill
                self._recent_s.append(dispatch_ns / 1e9)
                self._consecutive_failures = 0
            for req, boff, n in parts:
                req.parts.append(np.asarray(out[boff : boff + n]))
                req.done += n
                if req.done == len(req.images):
                    req.event.set()
        finally:
            self._release_capacity(fill + dropped_rows)

    def _run_spanned(self, block: np.ndarray, fill: int, first: list) -> tuple:
        """``(run_batch(block), its ns)``.  The batch is a request of its
        own, so the device function's spans take its id and the route's
        label; ``first``'s queue waits end where the dispatch starts."""
        with profiler.request(self.label):
            dispatch = profiler.span("batch.dispatch", rows=fill)
            try:
                with dispatch:
                    out = self._run_batch(block)
                return out, dispatch.ns
            finally:
                for req in first:
                    profiler.add("batch.queue_wait", req.enqueued, dispatch.t0,
                                 rows=len(req.images), request=req.request, parent=dispatch.id)
