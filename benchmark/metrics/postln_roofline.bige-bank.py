"""The post-norm residual of every bigE block, x + LN(branch), twice a
block (``layernorm_residual_rows``), against its bound over the window's
encodes (bytes: the branch and the residual read once, the sum written
once), by the kernel name's device seconds (device trace); None where the
trace holds no such kernel."""

from benchmark import work_eva_postnorm


def read(run):
    return work_eva_postnorm.roofline(run, work_eva_postnorm.POSTLN_PIECES,
                                      "layernorm_residual_rows")
