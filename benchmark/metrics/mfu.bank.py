"""The whole step's share of the card's peak: model operations of the
valid images encoded, over the window's wall time."""

from benchmark import readers


def read(run):
    return readers.mfu(run, "valid_images")
