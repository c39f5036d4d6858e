"""The SwiGLU GEMM (``gemm_bf16_eva<6>``: w1 and w2 in one product, the
silu-gated hidden written H wide) against its bound over the window's
encodes, by its kernel name's device seconds (device trace)."""

from benchmark import work_eva


def read(run):
    return work_eva.roofline(run, ("swiglu",), "gemm_bf16_eva<6>")
