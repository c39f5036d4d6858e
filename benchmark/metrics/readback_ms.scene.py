"""Mean time of a scene's copies of its top-k to the host, in which the
host waits for the card (``infer.readback``; program span)."""

from benchmark.program_spans import mean_ms


def read(run):
    return mean_ms(run, "infer.readback")
