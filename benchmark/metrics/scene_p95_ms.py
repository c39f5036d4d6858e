"""95th percentile of ``classify_objects`` wall time over every scene
that ended in the window (host clock)."""

from benchmark.stats import p95


def read(run):
    scenes = run.counters.get("scene_s")
    return p95(scenes) * 1e3 if scenes else None
