"""Mean time of a batch's copy of its features to the host, in which the
host waits for the card's encode (``encode_loader.readback``; program
span)."""

from benchmark.program_spans import mean_ms


def read(run):
    return mean_ms(run, "encode_loader.readback")
