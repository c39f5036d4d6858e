"""Host-to-card rate of the image batches: every ``encode.upload`` span's
bytes (the uint8 batch) over their time (program span)."""

from benchmark.program_spans import gb_per_s


def read(run):
    return gb_per_s(run, "encode.upload")
