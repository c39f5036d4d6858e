"""Readings that several per-layer metrics share; each metric's own file
(``metrics/<name>.py``) names what it reads."""

from __future__ import annotations

from typing import Optional

from benchmark import work


def idle_share(run) -> Optional[float]:
    """Share of the window in which the card ran no operation (device trace)."""
    if run.trace is None or not run.trace["window_s"]:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def mfu(run, images: str) -> Optional[float]:
    """The whole step's share of the card's peak: model operations of the
    counter ``images`` (images without padding), over the window's wall
    time, against the peak of the compute type (``work.PEAK_FLOPS``)."""
    if images not in run.counters:
        return None
    flops = run.counters[images] * work.image_flops(run.config)
    return 100.0 * flops / run.counters["window_s"] / work.PEAK_FLOPS[run.config["compute_dtype"]]
