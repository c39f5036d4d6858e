"""The whole step's share of the card's peak: EVA02 model operations of the
valid images encoded (``work_eva.image_flops``), over the window's wall
time."""

from benchmark import work_eva


def read(run):
    return work_eva.mfu(run)
