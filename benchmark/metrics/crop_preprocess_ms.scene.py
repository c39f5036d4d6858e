"""Host preprocess a crop: every ``classify.preprocess`` span's time over
its crops (program span)."""

from benchmark.program_spans import ms_per_row


def read(run):
    return ms_per_row(run, "classify.preprocess")
