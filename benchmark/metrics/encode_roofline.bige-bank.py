"""The bigE image encode's kernels against their roofline: the sum of every
piece's bound (``work_eva_postnorm.encode_pieces``: the products,
attention, the post-LN residuals, patch embedding and head, of the rows
handed to the encode) over all kernel time in the window (device trace)."""

from benchmark import work_eva_postnorm


def read(run):
    bound = work_eva_postnorm.encode_bound_s(run)
    if bound is None or run.trace is None or not run.trace["kernel_s"]:
        return None
    return 100.0 * bound / run.trace["kernel_s"]
