"""Valid images encoded over the whole window, divided by the window;
padding rows do not count (host clock)."""


def read(run):
    if "valid_images" not in run.counters:
        return None
    return run.counters["valid_images"] / run.counters["window_s"]
