"""The QKV GEMM with its RoPE epilogue (``gemm_bf16_eva<5>``) against its
bound over the window's encodes, by its kernel name's device seconds
(device trace)."""

from benchmark import work_eva


def read(run):
    return work_eva.roofline(run, ("qkv_rope",), "gemm_bf16_eva<5>")
