"""The SwiGLU hidden's sub-LN of every EVA02 block (``layernorm_sub_rows_kernel``,
over its true width H of the padded row) against its bound over the
window's encodes, by the kernel name's device seconds (device trace).  The
attention output's sub-LN runs on ``layernorm_rows``, under the name of
the block LayerNorms."""

from benchmark import work_eva


def read(run):
    return work_eva.roofline(run, ("ln_ffn",), "layernorm_sub_rows_kernel")
