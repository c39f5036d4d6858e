"""Hand-written Hopper kernels for the CLIP transformer block, with plain
PyTorch versions of each.

Counterpart of ``protoclip_tpu/ops/pallas_kernels.py``.  The TPU kernel K2
(``fused_transformer_block``) runs a whole residual block in one Pallas
call with the layer's weights resident in a 100 MB VMEM.  A Hopper SM has
227 KB of shared memory, so here K2 is a fixed chain of three CUDA kernels
(``csrc/``), each written by hand:

    layernorm_rows -> gemm_bias_epilogue(QKV) -> attention_packed
    -> gemm_bias_epilogue(out-proj + residual) -> layernorm_rows
    -> gemm_bias_epilogue(fc + QuickGELU) -> gemm_bias_epilogue(proj + residual)

K1 (``fused_attention_packed``) is a second entry to ``attention_packed``.

Every wrapper takes its plain version for tensors on the CPU and launches
its kernel for CUDA tensors, or raises; it never falls back.  The plain
versions keep the TPU kernel's cast points (fp32 LayerNorm statistics,
fp32 accumulation, the QKV/out-proj/proj outputs rounded to the activation
dtype before the bias add, the fc bias and QuickGELU in fp32, softmax in
fp32 with weights rounded to v's dtype), so they are the reference each
kernel is held to on the card.

``LAUNCHES`` counts, per wrapper, the calls that launched a kernel.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from protoclip_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # PCK_F32 / PCK_BF16 in csrc/common.cuh
_EPILOGUES = {"bias": 0, "bias_residual": 1, "bias_gelu": 2}
SMEM_PER_BLOCK = 232_448  # opt-in dynamic shared memory of one H100 block
MAX_HEAD_DIM = 128  # ATT_MAX_DH in csrc/attention_packed.cu
LN_EPS = 1e-5
# 65535 row tiles of 128 (bf16 WMMA) or 64 (fp32 SIMT) rows: csrc/gemm_bias_epilogue.cu
_MAX_GEMM_ROWS = {torch.bfloat16: 65535 * 128, torch.float32: 65535 * 64}

LAUNCHES: Dict[str, int] = {
    "layernorm_rows": 0,
    "gemm_bias_epilogue": 0,
    "attention_packed": 0,
    "fused_transformer_block": 0,
    "fused_attention_packed": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _require_cuda(name: str, dtype: torch.dtype, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of ``dtype``."""
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: activation dtype {dtype} not supported (float32 or bfloat16)")
    for arg, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} is on {t.device}; all tensors must be on the card")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


# -- layernorm_rows ------------------------------------------------------------


def layernorm_rows_plain(x, scale, bias, eps: float = LN_EPS):
    """LayerNorm over the last axis: fp32 statistics and affine, one cast
    back to ``x``'s dtype (``pallas_kernels.py:263-272``)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    c = xf - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    normed = c * torch.rsqrt(var + eps)
    return (normed * scale.float() + bias.float()).to(x.dtype)


def layernorm_rows(x, scale, bias, eps: float = LN_EPS):
    """``x`` (..., D) in the activation dtype; ``scale``/``bias`` (D,) fp32."""
    if not x.is_cuda:
        return layernorm_rows_plain(x, scale, bias, eps)
    d = x.shape[-1]
    _require_cuda("layernorm_rows", x.dtype, x=x)
    _require_cuda("layernorm_rows", torch.float32, scale=scale, bias=bias)
    if scale.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"layernorm_rows: scale/bias must be ({d},)")
    out = torch.empty_like(x)
    rows = x.numel() // d
    lib = _build.load_library()
    _build.check(
        lib.layernorm_rows(
            _DTYPES[x.dtype], x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), rows, d, eps, _stream(),
        ),
        "layernorm_rows",
    )
    LAUNCHES["layernorm_rows"] += 1
    return out


# -- gemm_bias_epilogue ----------------------------------------------------------


def gemm_bias_epilogue_plain(a, w, bias, epilogue: str, residual=None):
    """``a (..., K) . w (K, N)`` with fp32 accumulation and the block
    kernel's epilogues:

    - ``bias``:          T(T(acc) + b)                      (QKV)
    - ``bias_residual``: T(residual + T(T(acc) + b))        (out-proj, proj)
    - ``bias_gelu``:     T(QuickGELU(acc + f32(b))) in fp32  (fc)
    """
    dtype = a.dtype
    acc = torch.matmul(a.float(), w.float())  # bf16 products are exact in fp32
    if epilogue == "bias_gelu":
        h = acc + bias.float()
        return (h * torch.sigmoid(1.702 * h)).to(dtype)
    y = (acc.to(dtype).float() + bias.float()).to(dtype)
    if epilogue == "bias_residual":
        y = (residual.float() + y.float()).to(dtype)
    elif epilogue != "bias":
        raise ValueError(f"unknown epilogue {epilogue!r}; use {sorted(_EPILOGUES)}")
    return y


def gemm_bias_epilogue(a, w, bias, epilogue: str, residual=None):
    """``a`` (..., K), ``w`` (K, N), ``bias`` (N,), all in the activation
    dtype; ``residual`` (..., N) for ``bias_residual``."""
    if epilogue not in _EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; use {sorted(_EPILOGUES)}")
    if (residual is None) != (epilogue != "bias_residual"):
        raise ValueError("residual is given exactly for the bias_residual epilogue")
    if not a.is_cuda:
        return gemm_bias_epilogue_plain(a, w, bias, epilogue, residual)
    k, n = w.shape
    tensors = dict(a=a, w=w, bias=bias)
    if residual is not None:
        tensors["residual"] = residual
    _require_cuda("gemm_bias_epilogue", a.dtype, **tensors)
    if a.shape[-1] != k or bias.shape != (n,):
        raise ValueError(f"gemm_bias_epilogue: a {tuple(a.shape)}, w {tuple(w.shape)}, "
                         f"bias {tuple(bias.shape)} do not chain")
    out = torch.empty(*a.shape[:-1], n, dtype=a.dtype, device=a.device)
    if residual is not None and residual.shape != out.shape:
        raise ValueError(f"gemm_bias_epilogue: residual {tuple(residual.shape)} "
                         f"!= output {tuple(out.shape)}")
    m = a.numel() // k
    if m > _MAX_GEMM_ROWS[a.dtype]:
        raise ValueError(f"gemm_bias_epilogue: {m} rows > {_MAX_GEMM_ROWS[a.dtype]} (grid y limit)")
    lib = _build.load_library()
    _build.check(
        lib.gemm_bias_epilogue(
            _DTYPES[a.dtype], a.data_ptr(), w.data_ptr(), bias.data_ptr(),
            residual.data_ptr() if residual is not None else None,
            out.data_ptr(), m, n, k, _EPILOGUES[epilogue], _stream(),
        ),
        "gemm_bias_epilogue",
    )
    LAUNCHES["gemm_bias_epilogue"] += 1
    return out


# -- attention_packed ----------------------------------------------------------------


def fused_attention_packed_plain(q, k, v, n_head: int, causal: bool = False,
                                 length: Optional[int] = None):
    """Multi-head attention over packed ``(B, L, D)`` q, k, v with the TPU
    kernel's numerics (``pallas_kernels.py:145-183``).  Keys at index >=
    ``length`` (default L) are masked, and col > row when causal."""
    b, l, d = q.shape
    dh = d // n_head
    length = l if length is None else length
    dtype = v.dtype

    def heads(t):
        return t.reshape(b, l, n_head, dh).transpose(1, 2)

    s = torch.matmul(heads(q).float() * dh ** -0.5, heads(k).float().transpose(-1, -2))
    col = torch.arange(l, device=q.device)
    mask = (col >= length)[None, :].expand(l, l)
    if causal:
        mask = mask | (col[None, :] > col[:, None])
    s = s.masked_fill(mask, -1e30)
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    w = (e / e.sum(dim=-1, keepdim=True)).to(dtype)
    o = torch.matmul(w.float(), heads(v).float()).to(dtype)
    return o.transpose(1, 2).reshape(b, l, d)


def attention_packed(q, k, v, n_head: int, causal: bool = False,
                     length: Optional[int] = None):
    """The attention kernel on ``(B, L, D)`` views that share one row
    stride: separate contiguous tensors (K1) or column slices of a fused
    ``(B, L, 3D)`` QKV buffer (K2).  Returns a contiguous ``(B, L, D)``."""
    if not q.is_cuda:
        return fused_attention_packed_plain(q, k, v, n_head, causal, length)
    b, l, d = q.shape
    if d % n_head:
        raise ValueError(f"n_head={n_head} must divide feature dim {d}")
    dh = d // n_head
    length = l if length is None else length
    if not 1 <= length <= l:
        raise ValueError(f"length={length} must lie in [1, {l}]")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"attention_packed: head dim {dh} > {MAX_HEAD_DIM}")
    if b > 65535:
        raise ValueError(f"attention_packed: batch {b} > 65535 (grid z limit)")
    dtype = q.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"attention_packed: dtype {dtype} not supported")
    ld = q.stride(1)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dtype != dtype or t.shape != q.shape:
            raise ValueError(f"attention_packed: {name} must be a CUDA {dtype} {tuple(q.shape)}")
        if t.stride() != (l * ld, ld, 1):
            raise ValueError(f"attention_packed: {name} strides {t.stride()} are not "
                             f"(L*ld, ld, 1) with the shared row stride ld={ld}")
    lib = _build.load_library()
    smem = lib.attention_packed_smem_bytes(_DTYPES[dtype], l, dh)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"attention_packed: L={l}, dh={dh} in {dtype} needs {smem} B of "
                         f"shared memory > {SMEM_PER_BLOCK}")
    out = torch.empty(b, l, d, dtype=dtype, device=q.device)
    _build.check(
        lib.attention_packed(
            _DTYPES[dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), ld,
            out.data_ptr(), d, b, l, n_head, dh, length, int(causal), dh ** -0.5, _stream(),
        ),
        "attention_packed",
    )
    LAUNCHES["attention_packed"] += 1
    return out


def fused_attention_packed(q, k, v, n_head: int, causal: bool = False):
    """K1: fused multi-head attention over packed ``(B, L, D)`` q, k, v
    (``pallas_kernels.py:218``).  No padding: the kernel masks by length."""
    if not q.is_cuda:
        return fused_attention_packed_plain(q, k, v, n_head, causal)
    out = attention_packed(q, k, v, n_head, causal)
    LAUNCHES["fused_attention_packed"] += 1
    return out


# -- K2: the whole residual block ------------------------------------------------


def _block_args(block: dict, dtype: torch.dtype):
    """One layer's weights in the activation dtype and LN params in fp32,
    as the TPU wrapper casts them (``pallas_kernels.py:412-429``).  Both
    casts are no-ops for parameters already stored that way."""
    attn, mlp = block["attn"], block["mlp"]
    return dict(
        wqkv=attn["wqkv"].to(dtype), bqkv=attn["bqkv"].to(dtype),
        wo=attn["wo"].to(dtype), bo=attn["bo"].to(dtype),
        ln1s=block["ln_1"]["scale"].float(), ln1b=block["ln_1"]["bias"].float(),
        ln2s=block["ln_2"]["scale"].float(), ln2b=block["ln_2"]["bias"].float(),
        # rounded to the activation dtype here, widened to fp32 in the fc epilogue
        wfc=mlp["w_fc"].to(dtype), bfc=mlp["b_fc"].to(dtype),
        wproj=mlp["w_proj"].to(dtype), bproj=mlp["b_proj"].to(dtype),
    )


def _block_chain(x, p, n_head, causal, length, ln, gemm, attention):
    d = x.shape[-1]
    qkv = gemm(ln(x, p["ln1s"], p["ln1b"]), p["wqkv"], p["bqkv"], "bias")
    attn = attention(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], n_head, causal, length)
    x = gemm(attn, p["wo"], p["bo"], "bias_residual", residual=x)
    hid = gemm(ln(x, p["ln2s"], p["ln2b"]), p["wfc"], p["bfc"], "bias_gelu")
    return gemm(hid, p["wproj"], p["bproj"], "bias_residual", residual=x)


def _check_block_input(x, n_head: int, length: Optional[int]) -> None:
    b, l, d = x.shape
    if d % n_head:
        raise ValueError(f"n_head={n_head} must divide feature dim {d}")
    if length is not None and not 1 <= length <= l:
        raise ValueError(f"length={length} must lie in [1, {l}]")


def fused_transformer_block_plain(x, block: dict, n_head: int, causal: bool = False,
                                  length: Optional[int] = None):
    """K2's plain version, with the TPU kernel's cast points.  Not
    ``layers.residual_block``: that one runs the MLP in the activation
    dtype, while the kernel does the fc bias and QuickGELU in fp32."""
    _check_block_input(x, n_head, length)
    return _block_chain(
        x, _block_args(block, x.dtype), n_head, causal, length,
        layernorm_rows_plain, gemm_bias_epilogue_plain, fused_attention_packed_plain,
    )


def fused_transformer_block(x, block: dict, n_head: int, causal: bool = False,
                            length: Optional[int] = None):
    """K2: one CLIP residual block (``pallas_kernels.py:390``).

    ``x`` (B, L, D); ``block`` holds one layer's ``ln_1``, ``attn``
    (``wqkv`` (D, 3D), ``bqkv``, ``wo``, ``bo``), ``ln_2`` and ``mlp``.
    ``length``: number of valid rows when the caller padded L; keys beyond
    it are masked and the output keeps the padded shape.  L needs no
    padding here: the kernels mask by length.
    """
    if not x.is_cuda:
        return fused_transformer_block_plain(x, block, n_head, causal, length)
    _check_block_input(x, n_head, length)
    _require_cuda("fused_transformer_block", x.dtype, x=x)
    out = _block_chain(
        x, _block_args(block, x.dtype), n_head, causal, length,
        layernorm_rows, gemm_bias_epilogue, attention_packed,
    )
    LAUNCHES["fused_transformer_block"] += 1
    return out
