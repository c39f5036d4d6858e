"""The whole step's share of the card's peak: EVA02-CLIP-bigE model
operations of the valid images encoded (``work_eva_postnorm.image_flops``),
over the window's wall time."""

from benchmark import work_eva_postnorm


def read(run):
    return work_eva_postnorm.mfu(run)
