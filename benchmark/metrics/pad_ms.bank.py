"""Mean time of the loader's padded copy of a pass's short batch
(``loader.pad`` in ``ArrayLoader``; program span)."""

from benchmark.program_spans import mean_ms


def read(run):
    return mean_ms(run, "loader.pad")
