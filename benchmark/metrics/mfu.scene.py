"""The whole step's share of the card's peak: model operations of the
crops classified (no padding), over the window's wall time."""

from benchmark import readers


def read(run):
    return readers.mfu(run, "crops")
