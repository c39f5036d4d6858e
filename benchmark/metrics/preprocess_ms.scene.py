"""Mean host time a scene spends in ``classify_objects`` outside
``infer_canvases``: the PIL preprocess of its crops and the class names
(benchmark spans)."""


def read(run):
    scenes, infer = run.counters.get("scene_s"), run.counters.get("infer_s")
    if not scenes or len(infer) != len(scenes):
        return None
    return 1e3 * (sum(scenes) - sum(infer)) / len(scenes)
