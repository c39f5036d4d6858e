"""The port's ``MicroBatcher`` (``protoclip_tpu_torch/toolkit/microbatch.py``)
against the JAX package's, on the CPU.

Seeded submit schedules go through both batchers: serial ones, and bursts
queued behind a held dispatch (so the coalesced blocks are the same in
every run), with dispatches that fail at seeded points.  Each request's
result or error, every block the device function saw, and the statistics
(bar the wall-clock latency quantiles) must be equal.  Then every case of
``tests/test_microbatch.py`` (admission, coalescing, close, the release of
a failed request's rows, the health probe) runs on the port's class.
"""

import inspect
import threading
import time

import numpy as np
import pytest

import tests.test_microbatch as jax_cases
from protoclip_tpu.toolkit.microbatch import MicroBatcher as JaxMicroBatcher

from protoclip_tpu_torch.toolkit.microbatch import MicroBatcher

SHAPE = (2, 2, 1)
LATENCY_KEYS = ("dispatch_ms_p50", "dispatch_ms_p99", "dispatch_ms_max")


def _recorder(fail_at=()):
    """A device function that records each block and fails at the given
    dispatch indices."""
    seen = []

    def run(block):
        seen.append(np.array(block))
        if len(seen) - 1 in fail_at:
            raise RuntimeError(f"dispatch {len(seen) - 1} failed")
        return jax_cases._row_fn(block)

    return run, seen


def _outcome(fn):
    try:
        return ("ok", fn())
    except (RuntimeError, ValueError) as exc:
        return (type(exc).__name__, str(exc))


def _assert_same(ours, theirs):
    assert len(ours) == len(theirs)
    for (kind, value), (jkind, jvalue) in zip(ours, theirs):
        assert kind == jkind
        if kind == "ok":
            np.testing.assert_array_equal(value, jvalue)
        else:
            assert value == jvalue


def _stats(mb):
    return {k: v for k, v in mb.stats.items() if k not in LATENCY_KEYS}


def _serial(cls, sizes, fail_at, trim, batch, seed):
    rng = np.random.default_rng(seed)
    run, seen = _recorder(fail_at)
    mb = cls(run, batch, SHAPE, max_wait_s=0.0, max_pending=32, trim_underfull=trim)
    try:
        outcomes = [_outcome(lambda n=n: mb.submit(jax_cases._items(rng, n))) for n in sizes]
        return outcomes, seen, _stats(mb)
    finally:
        mb.close()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("trim", [False, True], ids=["padded", "trimmed"])
def test_serial_schedules_match_jax(seed, trim):
    rng = np.random.default_rng(100 + seed)
    batch = int(rng.integers(2, 6))
    sizes = [int(n) for n in rng.integers(1, 3 * batch, 12)]
    fail_at = {int(i) for i in rng.choice(20, 3, replace=False)}
    ours = _serial(MicroBatcher, sizes, fail_at, trim, batch, seed)
    theirs = _serial(JaxMicroBatcher, sizes, fail_at, trim, batch, seed)
    _assert_same(ours[0], theirs[0])
    assert len(ours[1]) == len(theirs[1])
    for block, jblock in zip(ours[1], theirs[1]):
        np.testing.assert_array_equal(block, jblock)
    assert ours[2] == theirs[2]
    assert any(kind == "RuntimeError" for kind, _ in ours[0])


def _burst(cls, sizes, fail_at, batch, seed):
    """Request 0 holds the first dispatch until requests 1.. are queued, in
    order; the burst then coalesces the same way in every run."""
    rng = np.random.default_rng(seed)
    inputs = [jax_cases._items(rng, n) for n in sizes]
    release = threading.Event()
    run, seen = _recorder(fail_at)

    def gated(block):
        if not seen:
            assert release.wait(timeout=30)
        return run(block)

    mb = cls(gated, batch, SHAPE, max_wait_s=0.0, max_pending=64)
    outcomes = [None] * len(inputs)

    def submit(i):
        outcomes[i] = _outcome(lambda: mb.submit(inputs[i]))

    threads = [threading.Thread(target=submit, args=(i,), daemon=True)
               for i in range(len(inputs))]
    try:
        threads[0].start()
        deadline = time.monotonic() + 30
        while mb._q.qsize() or not mb._thread.is_alive():  # request 0 taken
            time.sleep(0.002)
        for i, t in enumerate(threads[1:], 1):
            t.start()
            while mb._q.qsize() < i and time.monotonic() < deadline:
                time.sleep(0.002)
        assert mb._q.qsize() == len(inputs) - 1
        release.set()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        return outcomes, seen, _stats(mb)
    finally:
        release.set()
        mb.close()


@pytest.mark.parametrize("seed", range(3))
def test_coalesced_bursts_match_jax(seed):
    rng = np.random.default_rng(200 + seed)
    batch = int(rng.integers(3, 8))
    sizes = [1] + [int(n) for n in rng.integers(1, 2 * batch, 7)]
    fail_at = {int(rng.integers(1, 4))}
    ours = _burst(MicroBatcher, sizes, fail_at, batch, seed)
    theirs = _burst(JaxMicroBatcher, sizes, fail_at, batch, seed)
    _assert_same(ours[0], theirs[0])
    assert [b.shape for b in ours[1]] == [b.shape for b in theirs[1]]
    for block, jblock in zip(ours[1], theirs[1]):
        np.testing.assert_array_equal(block, jblock)
    assert ours[2] == theirs[2]
    assert ours[2]["mean_fill"] > 1.0  # the queued burst shared dispatches


JAX_CASES = sorted(name for name, fn in inspect.getmembers(jax_cases, inspect.isfunction)
                   if name.startswith("test_"))


@pytest.mark.parametrize("case", JAX_CASES)
def test_jax_microbatch_cases_on_the_port(case, monkeypatch):
    """``tests/test_microbatch.py``'s case, with its ``MicroBatcher`` the
    port's."""
    monkeypatch.setattr(jax_cases, "MicroBatcher", MicroBatcher)
    getattr(jax_cases, case)()


def test_the_jax_cases_are_all_run():
    assert len(JAX_CASES) == 17
    assert "test_health_probe_rate_limit_and_recovery" in JAX_CASES
    assert "test_failed_dispatch_releases_the_dropped_requests_tokens" in JAX_CASES


class _SlowEntryLock:
    """A lock that sleeps ``delay_s`` before the dispatcher thread enters it
    (other threads enter at once): it widens the window between a dispatch's
    answer and its statistics."""

    def __init__(self, lock, dispatcher, delay_s):
        self._lock, self._dispatcher, self._delay_s = lock, dispatcher, delay_s

    def __enter__(self):
        if threading.current_thread() is self._dispatcher:
            time.sleep(self._delay_s)
        return self._lock.__enter__()

    def __exit__(self, *exc):
        return self._lock.__exit__(*exc)


def test_a_reply_is_released_after_its_dispatch_is_counted():
    """``submit`` returns only once the dispatch that answered it is in
    ``stats``: a read right after a reply never misses it, however slowly
    the dispatcher reaches its statistics."""
    mb = MicroBatcher(jax_cases._row_fn, 4, SHAPE, max_wait_s=0.0)
    mb._stats_lock = _SlowEntryLock(mb._stats_lock, mb._thread, 0.2)
    try:
        mb.submit(jax_cases._items(np.random.default_rng(0), 3))
        assert mb.stats["dispatches"] == 1 and mb.stats["images"] == 3
    finally:
        mb.close()
