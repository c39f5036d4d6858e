"""The image encode's kernels against their roofline: the sum of every
piece's bound (``work.encode_pieces``: the products, attention,
LayerNorms, patch embedding and projection of the rows handed to the
encode) over all kernel time in the window (device trace)."""

from benchmark import work


def read(run):
    if run.trace is None or not run.trace["kernel_s"] or not run.counters.get("encode_rows"):
        return None
    dtype = run.config["compute_dtype"]
    bound = sum(work.encode_bound_s(run.config, rows, dtype)
                for rows in run.counters["encode_rows"])
    return 100.0 * bound / run.trace["kernel_s"]
