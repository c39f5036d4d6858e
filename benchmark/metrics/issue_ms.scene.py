"""Mean host time of ``infer_canvases`` from the pad to the bucket until
the last launch of the top-k returns (``infer.issue``; program span)."""

from benchmark.program_spans import mean_ms


def read(run):
    return mean_ms(run, "infer.issue")
