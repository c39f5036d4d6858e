"""The EVA02 image encode's kernels against their roofline: the sum of
every piece's bound (``work_eva.encode_pieces``: the products with the RoPE
and SwiGLU epilogues, attention, the LayerNorms and sub-LNs, patch
embedding and head, of the rows handed to the encode) over all kernel
time in the window (device trace)."""

from benchmark import work_eva


def read(run):
    if run.trace is None or not run.trace["kernel_s"] or not run.counters.get("encode_rows"):
        return None
    dtype = run.config["compute_dtype"]
    bound = sum(work_eva.pieces_bound_s(run.config, rows, None, dtype)
                for rows in run.counters["encode_rows"])
    return 100.0 * bound / run.trace["kernel_s"]
