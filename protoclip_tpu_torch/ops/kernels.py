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

K3 (``fused_transformer_block_int8``, the W8A8 serving block behind
``$PROTOCLIP_INT8``) is the same chain on int8 tensor cores, with the
activations quantized per row at four points:

    layernorm_quant_rows -> gemm_int8_epilogue(QKV) -> attention_packed
    -> quant_rows -> gemm_int8_epilogue(out-proj + residual)
    -> layernorm_quant_rows -> gemm_int8_epilogue(fc + QuickGELU, fp32)
    -> quant_rows -> gemm_int8_epilogue(proj + residual)

K1 (``fused_attention_packed``) and K4 (``fused_attention``, head-major)
are two more entries to ``attention_packed``.

The EVA02 image block of the EVA02-CLIP backbones (``fused_eva_block``; the
JAX package has no such block, so it replaces no TPU kernel) is a chain of
the same kernels with three more epilogues and a strided LayerNorm:

    layernorm_rows -> gemm_bias_eva(QKV + bias + RoPE on q and k)
    -> attention_packed -> layernorm_rows(inner LN, eps 1e-6)
    -> gemm_bias_epilogue(out-proj + residual) -> layernorm_rows
    -> gemm_bias_eva(w1 | w2 interleaved + SwiGLU) -> layernorm_sub_rows(ffn LN)
    -> gemm_bias_epilogue(w3 + residual)

and its text tower's MLP takes the exact-GELU fc epilogue
(``bias_gelu_erf``).

The post-norm image block of EVA02-CLIP-bigE (``fused_eva_postnorm_block``,
the port's own too) normalises each branch's output and adds it to a
residual stream that no LayerNorm touches, with one more kernel,
``layernorm_residual_rows`` (x + LN(branch)):

    gemm_bias_epilogue(QKV) -> attention_packed -> gemm_bias_epilogue(out-proj)
    -> layernorm_residual_rows(x + LN1) -> gemm_bias_epilogue(fc + exact GELU)
    -> gemm_bias_epilogue(proj) -> layernorm_residual_rows(x + LN2)

The block-variant bench (S1, ``scripts/bench_block_variants.py``, ported as
``ops/block_variants.py``) moves those cast points.  Its modes are modes of
the same kernels: q rounded to the activation dtype before the scores and
a no-softmax stand-in (``attention_packed``), QuickGELU op by op in bf16 and
an fp32-bias residual (``gemm_bias_epilogue``), three more dequant epilogues
(``gemm_int8_epilogue``), the recip/static/cast quantizers and bf16
LayerNorm statistics (``quant_rows.cu``).  Two kernels are its own:
``attention_int8`` (the int8 attention core of ``int8s``) and ``qkv_sum``
(q + k + v in place of attention).

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

import os
from typing import Dict, Optional

import torch

from protoclip_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # PCK_F32 / PCK_BF16 in csrc/common.cuh
_EPILOGUES = {"bias": 0, "bias_residual": 1, "bias_gelu": 2, "bias_gelu_bf16": 3,
              "bias32_residual": 4, "bias_gelu_erf": 7}
_EVA_EPILOGUES = {"bias_rope": 5, "bias_swiglu": 6}  # gemm_bias_eva, bf16 only
# the fc epilogue of a block's MLP activation
FC_EPILOGUES = {"quick_gelu": "bias_gelu", "gelu": "bias_gelu_erf"}
_RESIDUAL_EPILOGUES = ("bias_residual", "bias32_residual")
_INT8_EPILOGUES = {"dequant_bias": 0, "dequant_bias_residual": 1, "dequant_bias_gelu": 2,
                   "dequant_bias_gelu_bf16": 3, "dequant_bias_f32": 4,
                   "dequant_bias_gelu_round": 5}
_FP32_OUT_EPILOGUES = ("dequant_bias_gelu", "dequant_bias_f32")
_ATTENTION_MODES = {"softmax": 0, "q_round": 1, "no_softmax": 2}
_QUANT_MODES = {"dyn": 0, "recip": 1, "static": 2, "cast": 3}
STATIC_SCALE = 1.0 / 32.0  # the fixed activation scale of the static and cast quantizers
QUANT_FLOOR = 1e-6  # smallest amax a scale is taken from (pallas_kernels.py:465, :503)
SMEM_PER_BLOCK = 232_448  # opt-in dynamic shared memory of one H100 block
MAX_HEAD_DIM = 128  # ATT_MAX_DH in csrc/attention_packed.cu
LN_EPS = 1e-5
EVA_LN_EPS = 1e-6  # every LayerNorm of an EVA02 image tower
PIECE = 8  # elements the GEMM's and attention's sizes and strides are multiples of
INT8_K_PIECE = 16  # int8 K: the int8 GEMM's TMA rows are whole 16-byte pieces
QUANT_MAX_WIDTH = 4096  # widest row quant_rows.cu holds in registers

LAUNCHES: Dict[str, int] = {
    "layernorm_rows": 0,
    "gemm_bias_epilogue": 0,
    "attention_packed": 0,
    "fused_transformer_block": 0,
    "fused_attention_packed": 0,
    "layernorm_quant_rows": 0,
    "quant_rows": 0,
    "gemm_int8_epilogue": 0,
    "fused_transformer_block_int8": 0,
    "fused_attention": 0,
    # the EVA02-CLIP backbones' kernel and modes; each mode's launch also
    # counts under its kernel's name
    "layernorm_sub_rows": 0,
    "gemm_bias_epilogue.bias_rope": 0,
    "gemm_bias_epilogue.bias_swiglu": 0,
    "gemm_bias_epilogue.bias_gelu_erf": 0,
    "fused_eva_block": 0,
    # EVA02-CLIP-bigE's post-norm block and its kernel
    "layernorm_residual_rows": 0,
    "fused_eva_postnorm_block": 0,
    # modes of the kernels above that only the block-variant bench runs;
    # each launch also counts under its kernel's name
    "attention_packed.q_round": 0,
    "attention_packed.no_softmax": 0,
    "gemm_bias_epilogue.bias_gelu_bf16": 0,
    "gemm_bias_epilogue.bias32_residual": 0,
    "gemm_int8_epilogue.dequant_bias_gelu_bf16": 0,
    "gemm_int8_epilogue.dequant_bias_f32": 0,
    "gemm_int8_epilogue.dequant_bias_gelu_round": 0,
    "quant_rows.recip": 0,
    "quant_rows.static": 0,
    "quant_rows.cast": 0,
    "layernorm_quant_rows.recip": 0,
    "layernorm_quant_rows.static": 0,
    "layernorm_quant_rows.cast": 0,
    "layernorm_quant_rows.bf16_stats": 0,
    # kernels of the block-variant bench
    "attention_int8": 0,
    "qkv_sum": 0,
}
# the modes OpenAI's blocks run, counted under their kernel's name alone
_MAIN_MODES = ("softmax", "bias", "bias_residual", "bias_gelu", "dequant_bias",
               "dequant_bias_residual", "dequant_bias_gelu", "dyn")


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _count(kernel: str, *modes: str) -> None:
    """One launch of ``kernel``, and one under ``kernel.mode`` for each of
    its bench-only ``modes``; a mode with no counter raises."""
    LAUNCHES[kernel] += 1
    for mode in modes:
        if mode in _MAIN_MODES:
            continue
        name = f"{kernel}.{mode}"
        if name not in LAUNCHES:
            raise KeyError(f"no launch counter for mode {mode!r} of {kernel}")
        LAUNCHES[name] += 1


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _require_cuda(name: str, dtype: torch.dtype, **tensors: torch.Tensor) -> None:
    """Raise unless ``dtype`` is an activation dtype of the kernels and every
    tensor is a contiguous CUDA tensor of it."""
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: activation dtype {dtype} not supported (float32 or bfloat16)")
    _require_on_card(name, dtype, **tensors)


def _require_on_card(name: str, dtype: torch.dtype, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of ``dtype``."""
    for arg, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} is on {t.device}; all tensors must be on the card")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def require_pieces(name: str, sizes: Dict[str, int], tensors: Dict[str, torch.Tensor],
                   piece: int = PIECE) -> None:
    """Raise ``ValueError`` unless every size is a multiple of ``piece``
    elements (8: 16 bytes of bf16) and every tensor starts on a 16-byte
    boundary: the GEMMs (TMA), the attention (``cp.async``) and the
    quantizer move rows in whole 16-byte pieces.  A pure function of the
    sizes and the tensors' addresses."""
    for what, n in sizes.items():
        if n % piece:
            raise ValueError(f"{name}: {what}={n} is not a multiple of {piece}")
    for arg, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} does not start on a 16-byte boundary")


# -- layernorm_rows ------------------------------------------------------------


def _layernorm_f32(x, scale, bias, eps: float):
    """LayerNorm over the last axis with fp32 statistics and affine, in fp32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    c = xf - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    normed = c * torch.rsqrt(var + eps)
    return normed * scale.float() + bias.float()


def layernorm_rows_plain(x, scale, bias, eps: float = LN_EPS):
    """LayerNorm over the last axis: fp32 statistics and affine, one cast
    back to ``x``'s dtype (``pallas_kernels.py:263-272``)."""
    return _layernorm_f32(x, scale, bias, eps).to(x.dtype)


def layernorm_rows(x, scale, bias, eps: float = LN_EPS):
    """``x`` (..., D) in the activation dtype; ``scale``/``bias`` (D,) fp32.
    ``eps``: 1e-5 in OpenAI's towers, :data:`EVA_LN_EPS` in EVA02's."""
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
    _count("layernorm_rows")
    return out


def layernorm_sub_rows_plain(x, scale, bias, eps: float = EVA_LN_EPS):
    """LayerNorm over the first ``W = scale.shape[0]`` values of each row of
    ``x`` (..., S), as :func:`layernorm_rows_plain`; the ``S - W`` lanes
    past them come out 0 and enter no statistic."""
    w = scale.shape[0]
    y = layernorm_rows_plain(x[..., :w], scale, bias, eps)
    return torch.nn.functional.pad(y, (0, x.shape[-1] - w))


def layernorm_sub_rows(x, scale, bias, eps: float = EVA_LN_EPS):
    """The SwiGLU hidden's sub-LN of an EVA02 block (``csrc/layernorm_rows.cu``,
    its own kernel):
    ``x`` (..., S) contiguous in the activation dtype, S a multiple of 8;
    ``scale``/``bias`` (W,) fp32 with W <= S, the row's valid width."""
    if not x.is_cuda:
        return layernorm_sub_rows_plain(x, scale, bias, eps)
    stride, width = x.shape[-1], scale.shape[0]
    _require_cuda("layernorm_sub_rows", x.dtype, x=x)
    _require_cuda("layernorm_sub_rows", torch.float32, scale=scale, bias=bias)
    if bias.shape != (width,) or not 0 < width <= stride:
        raise ValueError(f"layernorm_sub_rows: scale/bias ({width},) against rows of {stride}")
    require_pieces("layernorm_sub_rows", {"row stride": stride}, {"x": x})
    out = torch.empty_like(x)
    lib = _build.load_library()
    _build.check(
        lib.layernorm_sub_rows(
            _DTYPES[x.dtype], x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            x.numel() // stride, width, stride, eps, _stream(),
        ),
        "layernorm_sub_rows",
    )
    _count("layernorm_sub_rows")
    return out


def layernorm_residual_rows_plain(a, x, scale, bias, eps: float = EVA_LN_EPS):
    """The post-norm residual: T(x + T(LN(a))), the LayerNorm of ``a`` as
    :func:`layernorm_rows_plain` (fp32 statistics and affine, rounded once),
    its sum with ``x`` in fp32 rounded once more."""
    return (x.float() + layernorm_rows_plain(a, scale, bias, eps).float()).to(x.dtype)


def layernorm_residual_rows(a, x, scale, bias, eps: float = EVA_LN_EPS):
    """:func:`layernorm_residual_rows_plain` on the card (``csrc/
    layernorm_rows.cu``): ``a`` (the branch) and ``x`` (the residual) (...,
    D) contiguous in the activation dtype, D a multiple of 8; ``scale``/
    ``bias`` (D,) fp32.  Each row of ``a`` and ``x`` is read once."""
    if not a.is_cuda:
        return layernorm_residual_rows_plain(a, x, scale, bias, eps)
    d = a.shape[-1]
    _require_cuda("layernorm_residual_rows", a.dtype, a=a, x=x)
    _require_cuda("layernorm_residual_rows", torch.float32, scale=scale, bias=bias)
    if x.shape != a.shape or scale.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"layernorm_residual_rows: a {tuple(a.shape)}, x {tuple(x.shape)}, "
                         f"scale/bias {tuple(scale.shape)} do not chain")
    require_pieces("layernorm_residual_rows", {"D": d}, {"a": a, "x": x})
    out = torch.empty_like(x)
    lib = _build.load_library()
    _build.check(
        lib.layernorm_residual_rows(
            _DTYPES[a.dtype], a.data_ptr(), x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), a.numel() // d, d, eps, _stream(),
        ),
        "layernorm_residual_rows",
    )
    _count("layernorm_residual_rows")
    return out


# -- gemm_bias_epilogue ----------------------------------------------------------


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant rounded to ``like``'s dtype, as JAX casts a weakly
    typed scalar to the dtype of the array it meets.  PyTorch would keep a
    Python scalar in fp32 against a bf16 tensor."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def quick_gelu_rounded(hb):
    """``hb * (1 / (1 + exp(-(hb * 1.702))))`` op by op in ``hb``'s dtype,
    every op rounded and 1.702 rounded to that dtype first, as JAX evaluates
    it on a bf16 array (``bench_block_variants.py:274``)."""
    t = hb * _const(1.702, hb)
    t = torch.exp(-t)
    t = _const(1.0, hb) + t
    t = _const(1.0, hb) / t
    return hb * t


def gemm_bias_epilogue_plain(a, w, bias, epilogue: str, residual=None):
    """``a (..., K) . w (K, N)`` with fp32 accumulation and the block
    kernel's epilogues:

    - ``bias``:            T(T(acc) + b)                      (QKV)
    - ``bias_residual``:   T(residual + T(T(acc) + b))        (out-proj, proj)
    - ``bias_gelu``:       T(QuickGELU(acc + f32(b))) in fp32  (fc)
    - ``bias_gelu_bf16``:  QuickGELU of T(acc + f32(b)) op by op in T
    - ``bias32_residual``: T(residual + T(acc + b)), ``b`` fp32
    - ``bias_gelu_erf``:   T(GELU(acc + f32(b))) in fp32, the exact
      (erf) GELU of the EVA02-CLIP text MLP
    """
    dtype = a.dtype
    acc = torch.matmul(a.float(), w.float())  # bf16 products are exact in fp32
    if epilogue == "bias_gelu":
        h = acc + bias.float()
        return (h * torch.sigmoid(1.702 * h)).to(dtype)
    if epilogue == "bias_gelu_erf":
        return torch.nn.functional.gelu(acc + bias.float()).to(dtype)
    if epilogue == "bias_gelu_bf16":
        return quick_gelu_rounded((acc + bias.float()).to(dtype))
    if epilogue == "bias32_residual":
        return (residual.float() + (acc + bias).to(dtype).float()).to(dtype)
    y = (acc.to(dtype).float() + bias.float()).to(dtype)
    if epilogue == "bias_residual":
        y = (residual.float() + y.float()).to(dtype)
    elif epilogue != "bias":
        raise ValueError(f"unknown epilogue {epilogue!r}; use {sorted(_EPILOGUES)}")
    return y


def gemm_bias_epilogue(a, w, bias, epilogue: str, residual=None):
    """``a`` (..., K), ``w`` (K, N), ``bias`` (N,), all in the activation
    dtype (``bias`` fp32 for ``bias32_residual``); ``residual`` (..., N)
    for the two residual epilogues."""
    if epilogue not in _EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; use {sorted(_EPILOGUES)}")
    if (residual is None) != (epilogue not in _RESIDUAL_EPILOGUES):
        raise ValueError(f"residual is given exactly for the {_RESIDUAL_EPILOGUES} epilogues")
    if not a.is_cuda:
        return gemm_bias_epilogue_plain(a, w, bias, epilogue, residual)
    k, n = w.shape
    tensors = dict(a=a, w=w)
    if residual is not None:
        tensors["residual"] = residual
    _require_cuda("gemm_bias_epilogue", a.dtype, **tensors)
    _require_on_card("gemm_bias_epilogue",
                     torch.float32 if epilogue == "bias32_residual" else a.dtype, bias=bias)
    if a.shape[-1] != k or bias.shape != (n,):
        raise ValueError(f"gemm_bias_epilogue: a {tuple(a.shape)}, w {tuple(w.shape)}, "
                         f"bias {tuple(bias.shape)} do not chain")
    out = torch.empty(*a.shape[:-1], n, dtype=a.dtype, device=a.device)
    if residual is not None and residual.shape != out.shape:
        raise ValueError(f"gemm_bias_epilogue: residual {tuple(residual.shape)} "
                         f"!= output {tuple(out.shape)}")
    require_pieces("gemm_bias_epilogue", {"K": k, "N": n}, {**tensors, "bias": bias})
    m = a.numel() // k
    lib = _build.load_library()
    _build.check(
        lib.gemm_bias_epilogue(
            _DTYPES[a.dtype], a.data_ptr(), w.data_ptr(), bias.data_ptr(),
            residual.data_ptr() if residual is not None else None,
            out.data_ptr(), m, n, k, _EPILOGUES[epilogue], _stream(),
        ),
        "gemm_bias_epilogue",
    )
    _count("gemm_bias_epilogue", epilogue)
    return out


def rotate_pairs(t, cos, sin):
    """``t * cos + rotate_half(t) * sin`` in ``t``'s dtype, with EVA's
    ``rotate_half`` over interleaved pairs: (t0, t1) -> (-t1, t0)."""
    turned = torch.stack((-t[..., 1::2], t[..., 0::2]), dim=-1).flatten(-2)
    return t * cos + turned * sin


def gemm_bias_rope_plain(a, w, bias, cos, sin, rot_cols: int):
    """An EVA02 block's QKV: ``a`` (B, L, K) . ``w`` (K, N) with fp32
    accumulation, y = T(acc + f32(b)) rounded once (``F.linear`` with its
    bias, as EVA-CLIP computes q and v); then for tokens 1..L-1 of each
    sequence, the first ``rot_cols`` columns (q and k) turned head by head
    by the fp32 tables ``cos``/``sin`` (L - 1, dh):
    T(rotate_pairs(f32(y))), rounded once as EVA-CLIP's ``type_as(v)``
    after its fp32 RoPE."""
    dtype = a.dtype
    y = (torch.matmul(a.float(), w.float()) + bias.float()).to(dtype)
    b, l, _ = y.shape
    dh = cos.shape[-1]
    q_k = y[:, 1:, :rot_cols].float().reshape(b, l - 1, rot_cols // dh, dh)
    turned = rotate_pairs(q_k, cos[:, None, :], sin[:, None, :])
    y[:, 1:, :rot_cols] = turned.reshape(b, l - 1, rot_cols).to(dtype)
    return y


def gemm_bias_swiglu_plain(a, w, bias):
    """An EVA02 block's SwiGLU: ``w`` (K, 2H) holds w1 and w2 interleaved by
    column, so acc = a . w + f32(b) in fp32 gives gate ``acc[..., 0::2]``
    and value ``acc[..., 1::2]``; out (..., H) = T(silu(gate) * value),
    rounded once."""
    acc = torch.matmul(a.float(), w.float()) + bias.float()
    return (torch.nn.functional.silu(acc[..., 0::2]) * acc[..., 1::2]).to(a.dtype)


def _launch_eva_gemm(name: str, epilogue: str, a, w, bias, out, cos=None, sin=None,
                     rot_cols: int = 0) -> None:
    k, n = w.shape
    tensors = dict(a=a, w=w, bias=bias)
    if a.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the EVA02 epilogues run in bfloat16 on the card, not {a.dtype}")
    _require_cuda(name, a.dtype, **tensors)
    if a.shape[-1] != k or bias.shape != (n,):
        raise ValueError(f"{name}: a {tuple(a.shape)}, w {tuple(w.shape)}, "
                         f"bias {tuple(bias.shape)} do not chain")
    require_pieces(name, {"K": k, "N": n}, {**tensors, "out": out})
    tokens = dh = 0
    if cos is not None:
        _require_cuda(name, torch.float32, cos=cos, sin=sin)
        tokens, dh = a.shape[-2], cos.shape[-1]
        if cos.shape != (tokens - 1, dh) or sin.shape != cos.shape or dh % 2 or rot_cols % dh:
            raise ValueError(f"{name}: RoPE tables {tuple(cos.shape)} for {tokens} tokens, "
                             f"{rot_cols} turned columns")
        require_pieces(name, {}, {"cos": cos, "sin": sin})
    lib = _build.load_library()
    _build.check(
        lib.gemm_bias_eva(
            _DTYPES[a.dtype], a.data_ptr(), w.data_ptr(), bias.data_ptr(),
            None if cos is None else cos.data_ptr(), None if sin is None else sin.data_ptr(),
            out.data_ptr(), a.numel() // k, n, k, _EVA_EPILOGUES[epilogue], tokens, rot_cols,
            dh, _stream(),
        ),
        name,
    )
    _count("gemm_bias_epilogue", epilogue)


def gemm_bias_rope(a, w, bias, cos, sin, rot_cols: int):
    """:func:`gemm_bias_rope_plain` on the card (``gemm_bias_eva``, the
    ``bias_rope`` epilogue): ``a`` (B, L, K) and ``w``/``bias`` in bf16,
    the tables fp32 (L - 1, dh)."""
    if not a.is_cuda:
        return gemm_bias_rope_plain(a, w, bias, cos, sin, rot_cols)
    out = torch.empty(*a.shape[:-1], w.shape[1], dtype=a.dtype, device=a.device)
    _launch_eva_gemm("gemm_bias_rope", "bias_rope", a, w, bias, out, cos, sin, rot_cols)
    return out


def gemm_bias_swiglu(a, w, bias):
    """:func:`gemm_bias_swiglu_plain` on the card (``gemm_bias_eva``, the
    ``bias_swiglu`` epilogue); ``w`` (K, 2H) with H a multiple of 8."""
    if not a.is_cuda:
        return gemm_bias_swiglu_plain(a, w, bias)
    out = torch.empty(*a.shape[:-1], w.shape[1] // 2, dtype=a.dtype, device=a.device)
    require_pieces("gemm_bias_swiglu", {"H": w.shape[1] // 2}, {})
    _launch_eva_gemm("gemm_bias_swiglu", "bias_swiglu", a, w, bias, out)
    return out


# -- attention_packed ----------------------------------------------------------------


def fused_attention_plain(q, k, v, causal: bool = False, length: Optional[int] = None,
                          mode: str = "softmax"):
    """Attention over head-major ``(B, H, L, dh)`` q, k, v with the TPU
    kernels' numerics (``pallas_kernels.py:65-96``, ``:160-183``): fp32
    scores of ``(q * dh^-0.5) . k^T``, keys at index >= ``length`` (default
    L) masked, and col > row when causal, softmax in fp32, the weights
    rounded to v's dtype, PV accumulated in fp32 and rounded once.

    The bench's modes (``bench_block_variants.py:212``, ``:657-665``):
    ``q_round`` scales q in its own dtype, T(q * T(dh^-0.5)), before the
    fp32 scores; ``no_softmax`` does too, then takes weights T(s * 0.005)
    over all L keys, with no mask and no softmax."""
    if mode not in _ATTENTION_MODES:
        raise ValueError(f"unknown attention mode {mode!r}; use {sorted(_ATTENTION_MODES)}")
    l, dh = q.shape[-2], q.shape[-1]
    length = l if length is None else length
    if mode == "softmax":
        qs = q.float() * dh ** -0.5
    else:
        qs = (q * _const(dh ** -0.5, q)).float()
    s = torch.matmul(qs, k.float().transpose(-1, -2))
    if mode == "no_softmax":
        w = (s * 0.005).to(v.dtype)
        return torch.matmul(w.float(), v.float()).to(v.dtype)
    col = torch.arange(l, device=q.device)
    mask = (col >= length)[None, :].expand(l, l)
    if causal:
        mask = mask | (col[None, :] > col[:, None])
    s = s.masked_fill(mask, -1e30)
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    w = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype)
    return torch.matmul(w.float(), v.float()).to(v.dtype)


def _heads(t, n_head: int):
    b, l, d = t.shape
    return t.reshape(b, l, n_head, d // n_head).transpose(1, 2)


def fused_attention_packed_plain(q, k, v, n_head: int, causal: bool = False,
                                 length: Optional[int] = None, mode: str = "softmax"):
    """Multi-head attention over packed ``(B, L, D)`` q, k, v with the TPU
    kernel's numerics (``pallas_kernels.py:145-183``): the heads are column
    blocks of D, each run through :func:`fused_attention_plain`."""
    b, l, d = q.shape
    o = fused_attention_plain(*(_heads(t, n_head) for t in (q, k, v)), causal, length, mode)
    return o.transpose(1, 2).reshape(b, l, d)


def _launch_attention(q, k, v, strides, out, out_strides, b: int, l: int, n_head: int,
                      dh: int, length: int, causal: bool, mode: str = "softmax") -> None:
    """Launch ``csrc/attention_packed.cu`` on q, k, v sharing the (batch,
    head, row) element ``strides``, into ``out`` with ``out_strides``."""
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"attention_packed: head dim {dh} > {MAX_HEAD_DIM}")
    if b > 65535:
        raise ValueError(f"attention_packed: batch {b} > 65535 (grid z limit)")
    names = ("batch stride", "head stride", "row stride")
    require_pieces("attention_packed", {"dh": dh, **dict(zip(names, strides)),
                                        **{"out " + n: st for n, st in zip(names, out_strides)}},
                   {"q": q, "k": k, "v": v, "out": out})
    lib = _build.load_library()
    dtype = _DTYPES[q.dtype]
    smem = lib.attention_packed_smem_bytes(dtype, l, dh)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"attention_packed: L={l}, dh={dh} in {q.dtype} needs {smem} B of "
                         f"shared memory > {SMEM_PER_BLOCK}")
    _build.check(
        lib.attention_packed(
            dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides, out.data_ptr(),
            *out_strides, b, l, n_head, dh, length, int(causal), _ATTENTION_MODES[mode],
            dh ** -0.5, _stream(),
        ),
        "attention_packed",
    )


def _check_packed(name: str, q, k, v, n_head: int):
    """(dh, row stride) of ``(B, L, D)`` CUDA views that share one row stride."""
    b, l, d = q.shape
    if d % n_head:
        raise ValueError(f"n_head={n_head} must divide feature dim {d}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported")
    ld = q.stride(1)
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{name}: {arg} must be a CUDA {q.dtype} {tuple(q.shape)}")
        if t.stride() != (l * ld, ld, 1):
            raise ValueError(f"{name}: {arg} strides {t.stride()} are not "
                             f"(L*ld, ld, 1) with the shared row stride ld={ld}")
    return d // n_head, ld


def attention_packed(q, k, v, n_head: int, causal: bool = False,
                     length: Optional[int] = None, mode: str = "softmax"):
    """The attention kernel on ``(B, L, D)`` views that share one row
    stride: separate contiguous tensors (K1) or column slices of a fused
    ``(B, L, 3D)`` QKV buffer (K2, K3).  Returns a contiguous ``(B, L, D)``.
    ``mode``: see :func:`fused_attention_plain`."""
    if mode not in _ATTENTION_MODES:
        raise ValueError(f"unknown attention mode {mode!r}; use {sorted(_ATTENTION_MODES)}")
    if not q.is_cuda:
        return fused_attention_packed_plain(q, k, v, n_head, causal, length, mode)
    b, l, d = q.shape
    dh, ld = _check_packed("attention_packed", q, k, v, n_head)
    length = l if length is None else length
    if not 1 <= length <= l:
        raise ValueError(f"length={length} must lie in [1, {l}]")
    out = torch.empty(b, l, d, dtype=q.dtype, device=q.device)
    _launch_attention(q, k, v, (l * ld, dh, ld), out, (l * d, dh, d), b, l, n_head, dh,
                      length, causal, mode)
    _count("attention_packed", mode)
    return out


def fused_attention_packed(q, k, v, n_head: int, causal: bool = False):
    """K1: fused multi-head attention over packed ``(B, L, D)`` q, k, v
    (``pallas_kernels.py:218``).  No padding: the kernel masks by length."""
    if not q.is_cuda:
        return fused_attention_packed_plain(q, k, v, n_head, causal)
    out = attention_packed(q, k, v, n_head, causal)
    _count("fused_attention_packed")
    return out


def fused_attention(q, k, v, causal: bool = False):
    """K4: fused attention over head-major ``(B, H, L, dh)`` q, k, v
    (``pallas_kernels.py:121``), the same kernel read through head-major
    strides.  No padding: the kernel masks by length where the TPU wrapper
    pads L to a multiple of 8."""
    if not q.is_cuda:
        return fused_attention_plain(q, k, v, causal)
    b, h, l, dh = q.shape
    _require_cuda("fused_attention", q.dtype, q=q, k=k, v=v)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"fused_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} differ")
    out = torch.empty_like(q)
    strides = (h * l * dh, l * dh, dh)
    _launch_attention(q, k, v, strides, out, strides, b, l, h, dh, l, causal)
    _count("fused_attention")
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


def _block_chain(x, p, n_head, causal, length, ln, gemm, attention, fc="bias_gelu"):
    d = x.shape[-1]
    qkv = gemm(ln(x, p["ln1s"], p["ln1b"]), p["wqkv"], p["bqkv"], "bias")
    attn = attention(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], n_head, causal, length)
    x = gemm(attn, p["wo"], p["bo"], "bias_residual", residual=x)
    hid = gemm(ln(x, p["ln2s"], p["ln2b"]), p["wfc"], p["bfc"], fc)
    return gemm(hid, p["wproj"], p["bproj"], "bias_residual", residual=x)


def _check_block_input(x, n_head: int, length: Optional[int]) -> None:
    b, l, d = x.shape
    if d % n_head:
        raise ValueError(f"n_head={n_head} must divide feature dim {d}")
    if length is not None and not 1 <= length <= l:
        raise ValueError(f"length={length} must lie in [1, {l}]")


def fused_transformer_block_plain(x, block: dict, n_head: int, causal: bool = False,
                                  length: Optional[int] = None, act: str = "quick_gelu"):
    """K2's plain version, with the TPU kernel's cast points.  Not
    ``layers.residual_block``: that one runs the MLP in the activation
    dtype, while the kernel does the fc bias and its activation in fp32."""
    _check_block_input(x, n_head, length)
    return _block_chain(
        x, _block_args(block, x.dtype), n_head, causal, length,
        layernorm_rows_plain, gemm_bias_epilogue_plain, fused_attention_packed_plain,
        FC_EPILOGUES[act],
    )


def fused_transformer_block(x, block: dict, n_head: int, causal: bool = False,
                            length: Optional[int] = None, act: str = "quick_gelu"):
    """K2: one CLIP residual block (``pallas_kernels.py:390``).

    ``x`` (B, L, D); ``block`` holds one layer's ``ln_1``, ``attn``
    (``wqkv`` (D, 3D), ``bqkv``, ``wo``, ``bo``), ``ln_2`` and ``mlp``.
    ``length``: number of valid rows when the caller padded L; keys beyond
    it are masked and the output keeps the padded shape.  L needs no
    padding here: the kernels mask by length.  ``act``: the MLP's
    activation, OpenAI's ``quick_gelu`` or the exact ``gelu`` of the
    EVA02-CLIP text towers (:data:`FC_EPILOGUES`).
    """
    if not x.is_cuda:
        return fused_transformer_block_plain(x, block, n_head, causal, length, act)
    _check_block_input(x, n_head, length)
    _require_cuda("fused_transformer_block", x.dtype, x=x)
    out = _block_chain(
        x, _block_args(block, x.dtype), n_head, causal, length,
        layernorm_rows, gemm_bias_epilogue, attention_packed, FC_EPILOGUES[act],
    )
    _count("fused_transformer_block")
    return out


# -- the EVA02 image block ---------------------------------------------------------------


def _eva_block_args(block: dict, dtype: torch.dtype):
    """One EVA02 layer (``models/eva.py``) in the activation dtype, its
    LayerNorm parameters in fp32; casts that are no-ops for parameters
    stored that way."""
    attn, mlp = block["attn"], block["mlp"]

    def ln(p):
        return p["scale"].float(), p["bias"].float()

    return dict(
        ln1=ln(block["ln_1"]), ln2=ln(block["ln_2"]), ln_inner=ln(attn["ln_inner"]),
        ln_ffn=ln(mlp["ln_ffn"]),
        wqkv=attn["wqkv"].to(dtype), bqkv=attn["bqkv"].to(dtype),
        wo=attn["wo"].to(dtype), bo=attn["bo"].to(dtype),
        w12=mlp["w12"].to(dtype), b12=mlp["b12"].to(dtype),
        w3=mlp["w3"].to(dtype), b3=mlp["b3"].to(dtype),
    )


def _eva_block_chain(x, p, n_head, cos, sin, ln, ln_sub, gemm, gemm_rope, gemm_swiglu,
                     attention):
    d = x.shape[-1]
    qkv = gemm_rope(ln(x, *p["ln1"], EVA_LN_EPS), p["wqkv"], p["bqkv"], cos, sin, 2 * d)
    attn = attention(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], n_head)
    attn = ln(attn, *p["ln_inner"], EVA_LN_EPS)
    x = gemm(attn, p["wo"], p["bo"], "bias_residual", residual=x)
    hid = gemm_swiglu(ln(x, *p["ln2"], EVA_LN_EPS), p["w12"], p["b12"])
    hid = ln_sub(hid, *p["ln_ffn"], EVA_LN_EPS)
    return gemm(hid, p["w3"], p["b3"], "bias_residual", residual=x)


def _check_eva_input(x, n_head: int, cos) -> None:
    _check_block_input(x, n_head, None)
    l, d = x.shape[-2:]
    if cos.shape != (l - 1, d // n_head):
        raise ValueError(f"fused_eva_block: RoPE tables {tuple(cos.shape)} for {l} tokens of "
                         f"{n_head} heads of {d // n_head}")


def fused_eva_block_plain(x, block: dict, n_head: int, cos, sin):
    """The EVA02 block's plain version.  Cast points (T: the activation
    dtype; LayerNorms with fp32 statistics and affine, rounded once, eps
    1e-6):

    - h = T(LN1(x)); qkv = T(h . Wqkv + b) with bqkv = [bq, 0, bv]; q and
      k of tokens 1.. turned by the fp32 RoPE tables and rounded once
      (:func:`gemm_bias_rope_plain`);
    - o = attention as K2's (fp32 scores and softmax, weights rounded to
      T, PV in fp32 rounded once); o = T(LN_inner(o));
    - x = T(x + T(T(o . Wo) + bo)), K2's ``bias_residual``;
    - g = T(silu(h2 . W1 + b1) * (h2 . W2 + b2)) in fp32 from h2 =
      T(LN2(x)) (:func:`gemm_bias_swiglu_plain`); g = T(LN_ffn(g)) over
      its true width, the padded lanes 0;
    - x = T(x + T(T(g . W3) + b3)).
    """
    _check_eva_input(x, n_head, cos)
    return _eva_block_chain(
        x, _eva_block_args(block, x.dtype), n_head, cos, sin, layernorm_rows_plain,
        layernorm_sub_rows_plain, gemm_bias_epilogue_plain, gemm_bias_rope_plain,
        gemm_bias_swiglu_plain, fused_attention_packed_plain,
    )


def fused_eva_block(x, block: dict, n_head: int, cos, sin):
    """One EVA02 image block (EVA-CLIP ``eva_vit_model.py::Block`` with
    ``subln``, ``naiveswiglu`` and ``rope``): pre-LN attention with 2D RoPE
    on q and k of every token but the first, a LayerNorm on the attention
    output before its projection, and a SwiGLU MLP with a LayerNorm on its
    hidden.  ``x`` (B, L, D); ``block`` from ``models/eva.py``; ``cos``,
    ``sin`` (L - 1, dh) fp32.  On the card the chain runs in bf16."""
    if not x.is_cuda:
        return fused_eva_block_plain(x, block, n_head, cos, sin)
    _check_eva_input(x, n_head, cos)
    _require_cuda("fused_eva_block", x.dtype, x=x)
    out = _eva_block_chain(
        x, _eva_block_args(block, x.dtype), n_head, cos, sin, layernorm_rows,
        layernorm_sub_rows, gemm_bias_epilogue, gemm_bias_rope, gemm_bias_swiglu,
        attention_packed,
    )
    _count("fused_eva_block")
    return out


# -- the post-norm EVA-CLIP image block --------------------------------------------------


def _eva_postnorm_block_chain(x, p, n_head, ln_residual, gemm, attention):
    d = x.shape[-1]
    qkv = gemm(x, p["wqkv"], p["bqkv"], "bias")
    attn = attention(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], n_head)
    x = ln_residual(gemm(attn, p["wo"], p["bo"], "bias"), x, p["ln1s"], p["ln1b"], EVA_LN_EPS)
    hid = gemm(x, p["wfc"], p["bfc"], "bias_gelu_erf")
    return ln_residual(gemm(hid, p["wproj"], p["bproj"], "bias"), x, p["ln2s"], p["ln2b"],
                       EVA_LN_EPS)


def fused_eva_postnorm_block_plain(x, block: dict, n_head: int):
    """The post-norm block's plain version.  ``block`` has K2's layout
    (``ln_1``, ``attn`` with ``bqkv`` = [bq, 0, bv], ``ln_2``, ``mlp``).
    Cast points (T: the activation dtype; LayerNorms with fp32 statistics
    and affine, eps 1e-6):

    - qkv = T(T(x . Wqkv) + bqkv), K2's ``bias`` epilogue, with no
      LayerNorm before it;
    - o = attention as K2's (fp32 scores of (q * dh^-0.5) . k^T, softmax in
      fp32, weights rounded to T, PV in fp32 rounded once);
    - a = T(T(o . Wo) + bo);
    - x = T(x + T(LN1(a))) (:func:`layernorm_residual_rows_plain`);
    - h = T(GELU(x . W_fc + f32(b_fc))) in fp32, the exact (erf) GELU
      (``bias_gelu_erf``);
    - m = T(T(h . W_proj) + b_proj);
    - x = T(x + T(LN2(m))).
    """
    _check_block_input(x, n_head, None)
    return _eva_postnorm_block_chain(x, _block_args(block, x.dtype), n_head,
                                     layernorm_residual_rows_plain, gemm_bias_epilogue_plain,
                                     fused_attention_packed_plain)


def fused_eva_postnorm_block(x, block: dict, n_head: int):
    """One post-norm image block of EVA02-CLIP-bigE (EVA-CLIP
    ``eva_vit_model.py::Block`` with ``postnorm``: x + LN1(Attn(x)), then x +
    LN2(MLP(x)); a fused QKV with q and v biases, an exact-GELU MLP), in 7
    launches.  ``x`` (B, L, D); ``block`` from ``models/eva.py``.  On the
    card it runs in bf16 alone: other activation dtypes raise."""
    if not x.is_cuda:
        return fused_eva_postnorm_block_plain(x, block, n_head)
    if x.dtype != torch.bfloat16:
        raise TypeError("fused_eva_postnorm_block: the post-norm EVA-CLIP block runs in bfloat16 "
                        f"on the card, not {x.dtype}")
    _check_block_input(x, n_head, None)
    _require_cuda("fused_eva_postnorm_block", x.dtype, x=x)
    out = _eva_postnorm_block_chain(x, _block_args(block, x.dtype), n_head,
                                    layernorm_residual_rows, gemm_bias_epilogue,
                                    attention_packed)
    _count("fused_eva_postnorm_block")
    return out


# -- K3: the W8A8 serving block ------------------------------------------------------


def int8_enabled() -> bool:
    """Run the transformer blocks in W8A8 (K3)?  Opt-in with
    ``$PROTOCLIP_INT8``, as ``pallas_kernels.py:455-457``."""
    return os.environ.get("PROTOCLIP_INT8", "0").lower() in ("1", "true", "on")


def _div127(t):
    """``t / 127`` as an IEEE division on every device: divided by a Python
    number, PyTorch on the card multiplies by the reciprocal instead, which
    may be an ulp off."""
    return t / torch.tensor(127.0, device=t.device)


def _round_to_int8(t):
    """Round half to even (``jnp.round``) and clip to +-127."""
    return torch.round(t).clamp_(-127, 127).to(torch.int8)


def quantize_cols(w):
    """Per-output-channel symmetric int8 of an ``(in, out)`` weight, or of
    a stack ``(..., in, out)`` -> (int8 values in the same layout, fp32
    scales ``(..., 1, out)``), as ``pallas_kernels.py:460-468``."""
    w32 = w.float()
    scale = _div127(w32.abs().amax(dim=-2, keepdim=True).clamp_min(QUANT_FLOOR))
    return _round_to_int8(w32 / scale), scale


def quantize_block(block: dict) -> dict:
    """One layer's weights for K3, as one layer of
    ``quantize_stacked_blocks`` (``pallas_kernels.py:471-497``): the fused
    QKV, out, fc and proj matrices in int8 with per-output-column fp32
    scales ``(out,)``; biases and LayerNorm parameters in fp32.  Each int8
    matrix is stored ``(out, in)``: K-major, the layout the int8 GEMM
    kernel reads, transposed once here."""
    attn, mlp = block["attn"], block["mlp"]
    qblock = {}
    for name, w in (("qkv", attn["wqkv"]), ("o", attn["wo"]),
                    ("fc", mlp["w_fc"]), ("proj", mlp["w_proj"])):
        q, scale = quantize_cols(w)
        qblock["w" + name] = q.t().contiguous()
        qblock["s" + name] = scale.reshape(-1)
    qblock.update(
        bqkv=attn["bqkv"].float(), bo=attn["bo"].float(),
        bfc=mlp["b_fc"].float(), bproj=mlp["b_proj"].float(),
        ln1s=block["ln_1"]["scale"].float(), ln1b=block["ln_1"]["bias"].float(),
        ln2s=block["ln_2"]["scale"].float(), ln2b=block["ln_2"]["bias"].float(),
    )
    return qblock


# -- quant_rows ------------------------------------------------------------------------


def quant_rows_plain(x, mode: str = "dyn"):
    """Per-row symmetric int8 (``pallas_kernels.py:500-505``): ``(..., W)``
    in any float dtype -> (int8 ``(..., W)``, fp32 scales ``(..., 1)``),
    scale = max(amax, 1e-6) / 127.

    The bench's quantizers (``bench_block_variants.py:758-791``):
    ``recip`` q = round(x * (127 / amax)), scale = amax * f32(1/127);
    ``static`` q = clip(round(x * 32)), scale 1/32; ``cast`` x * 32
    truncated toward zero and saturated to [-128, 127], NaN -> 0 (XLA's
    f32 -> s8 convert), scale 1/32."""
    if mode not in _QUANT_MODES:
        raise ValueError(f"unknown quantizer {mode!r}; use {sorted(_QUANT_MODES)}")
    xf = x.float()
    if mode in ("static", "cast"):
        t = xf * 32.0
        if mode == "static":
            q = _round_to_int8(t)
        else:
            q = torch.trunc(torch.nan_to_num(t, nan=0.0)).clamp_(-128, 127).to(torch.int8)
        return q, torch.full((*x.shape[:-1], 1), STATIC_SCALE, dtype=torch.float32, device=x.device)
    amax = xf.abs().amax(dim=-1, keepdim=True).clamp_min(QUANT_FLOOR)
    if mode == "recip":
        r = torch.full_like(amax, 127.0) / amax  # a true division, as 127.0 / amax in JAX
        return _round_to_int8(xf * r), amax * (1.0 / 127.0)
    scale = _div127(amax)
    return _round_to_int8(xf / scale), scale


def _layernorm_bf16_stats(x, scale, bias, eps: float):
    """int8lnb's LayerNorm (``bench_block_variants.py:798-807``): mean and
    variance in ``x``'s dtype (fp32 sums, each result rounded), c = T(x -
    mean) and T(c * c) rounded, then rsqrt and the affine in fp32."""
    n = torch.tensor(float(x.shape[-1]), device=x.device)
    mean = (x.float().sum(dim=-1, keepdim=True) / n).to(x.dtype)
    c = x - mean
    var = ((c * c).float().sum(dim=-1, keepdim=True) / n).to(x.dtype)
    return c.float() * torch.rsqrt(var.float() + eps) * scale.float() + bias.float()


def layernorm_quant_rows_plain(x, scale, bias, eps: float = LN_EPS, mode: str = "dyn",
                               bf16_stats: bool = False):
    """K3's LayerNorm (``pallas_kernels.py:527-534``), left in fp32, then
    quantized per row: it is not rounded to the activation dtype as in K2.
    ``mode``: the quantizer (:func:`quant_rows_plain`); ``bf16_stats``: the
    statistics in ``x``'s dtype (bf16 on the bench), int8lnb's LayerNorm."""
    ln = _layernorm_bf16_stats if bf16_stats else _layernorm_f32
    return quant_rows_plain(ln(x, scale, bias, eps), mode)


def require_quant_width(name: str, w: int, tensors: Dict[str, torch.Tensor]) -> None:
    """Raise ``ValueError`` unless the row width ``w`` is a multiple of 8 up
    to :data:`QUANT_MAX_WIDTH` and every tensor starts on 16 bytes:
    ``quant_rows.cu`` holds a row in registers, read in 16-byte pieces."""
    if not 0 < w <= QUANT_MAX_WIDTH:
        raise ValueError(f"{name}: row width {w} is not in [8, {QUANT_MAX_WIDTH}]")
    require_pieces(name, {"W": w}, tensors)


def _launch_quant_rows(name: str, x, scale, bias, eps: float, mode: str = "dyn",
                       bf16_stats: bool = False):
    w = x.shape[-1]
    ln = {} if scale is None else {"scale": scale, "bias": bias}
    require_quant_width(name, w, {"x": x, **ln})
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty(*x.shape[:-1], 1, dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    _build.check(
        lib.quant_rows(
            _DTYPES[x.dtype], x.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if bias is None else bias.data_ptr(),
            q.data_ptr(), s.data_ptr(), x.numel() // w, w, eps, _QUANT_MODES[mode],
            int(bf16_stats), _stream(),
        ),
        name,
    )
    _count(name, mode, *(("bf16_stats",) if bf16_stats else ()))
    return q, s


def quant_rows(x, mode: str = "dyn"):
    """``x`` (..., W) in bf16 or fp32 -> (int8 (..., W), fp32 (..., 1)):
    ``csrc/quant_rows.cu`` in mode (b), with the quantizer ``mode``."""
    if mode not in _QUANT_MODES:
        raise ValueError(f"unknown quantizer {mode!r}; use {sorted(_QUANT_MODES)}")
    if not x.is_cuda:
        return quant_rows_plain(x, mode)
    _require_cuda("quant_rows", x.dtype, x=x)
    return _launch_quant_rows("quant_rows", x, None, None, 0.0, mode)


def layernorm_quant_rows(x, scale, bias, eps: float = LN_EPS, mode: str = "dyn",
                         bf16_stats: bool = False):
    """``x`` (..., D) in the activation dtype, ``scale``/``bias`` (D,) fp32
    -> the quantized fp32 LayerNorm: ``csrc/quant_rows.cu`` in mode (a)."""
    if mode not in _QUANT_MODES:
        raise ValueError(f"unknown quantizer {mode!r}; use {sorted(_QUANT_MODES)}")
    if not x.is_cuda:
        return layernorm_quant_rows_plain(x, scale, bias, eps, mode, bf16_stats)
    d = x.shape[-1]
    _require_cuda("layernorm_quant_rows", x.dtype, x=x)
    _require_on_card("layernorm_quant_rows", torch.float32, scale=scale, bias=bias)
    if scale.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"layernorm_quant_rows: scale/bias must be ({d},)")
    return _launch_quant_rows("layernorm_quant_rows", x, scale, bias, eps, mode, bf16_stats)


# -- gemm_int8_epilogue -------------------------------------------------------------------


def int8_matmul_plain(x_q, x_s, w_q, w_s):
    """``(..., in)`` int8 . ``(in, out)`` int8 -> fp32, dequantized as
    ``f32(acc) * x_s * w_s`` (``pallas_kernels.py:508-513``).  The sum runs
    in float64, exact below 2**53 (fp32 is not: 3072 * 127**2 > 2**24), and
    is rounded to fp32 once, as int32 -> fp32 does."""
    acc = torch.matmul(x_q.double(), w_q.double()).float()
    return acc * x_s * w_s


def gemm_int8_epilogue_plain(a_q, a_s, w_q, w_s, bias, epilogue: str, dtype: torch.dtype,
                             residual=None):
    """``a_q (..., K)`` int8 with row scales ``a_s (..., 1)``, times ``w_q``
    stored ``(N, K)`` with column scales ``w_s (N,)``, plus the fp32 bias,
    with K3's epilogues (T rounds to the activation ``dtype``):

    - ``dequant_bias``:          T(y)                           (QKV)
    - ``dequant_bias_residual``: T(f32(residual) + f32(T(y)))   (out-proj, proj)
    - ``dequant_bias_gelu``:     y * sigmoid(1.702 y) in fp32   (fc)

    and the bench's (``bench_block_variants.py:516-523``, ``:880-894``):

    - ``dequant_bias_gelu_bf16``:  QuickGELU of T(y) op by op in T
    - ``dequant_bias_f32``:        y in fp32
    - ``dequant_bias_gelu_round``: T(y * sigmoid(1.702 y))

    where ``y = f32(acc) * a_s * w_s + bias`` in fp32.
    """
    y = int8_matmul_plain(a_q, a_s, w_q.t(), w_s) + bias
    if epilogue == "dequant_bias_f32":
        return y
    if epilogue == "dequant_bias_gelu_bf16":
        return quick_gelu_rounded(y.to(dtype))
    if epilogue in ("dequant_bias_gelu", "dequant_bias_gelu_round"):
        h = y * torch.sigmoid(1.702 * y)
        return h if epilogue == "dequant_bias_gelu" else h.to(dtype)
    if epilogue == "dequant_bias":
        return y.to(dtype)
    if epilogue == "dequant_bias_residual":
        return (residual.float() + y.to(dtype).float()).to(dtype)
    raise ValueError(f"unknown epilogue {epilogue!r}; use {sorted(_INT8_EPILOGUES)}")


def require_int8_pieces(name: str, k: int, n: int, tensors: Dict[str, torch.Tensor]) -> None:
    """Raise ``ValueError`` unless K is a multiple of 16, N of 8 and every
    tensor starts on 16 bytes: the int8 GEMM's TMA rows are K bytes, and its
    output rows go out in 16-byte pieces."""
    require_pieces(name, {"K": k}, {}, piece=INT8_K_PIECE)
    require_pieces(name, {"N": n}, tensors)


def gemm_int8_epilogue(a_q, a_s, w_q, w_s, bias, epilogue: str, dtype: torch.dtype,
                       residual=None):
    """``csrc/gemm_int8_epilogue.cu``: ``a_q`` (..., K) int8, ``a_s`` its
    fp32 row scales (..., 1), ``w_q`` (N, K) int8, ``w_s``/``bias`` (N,)
    fp32, ``residual`` (..., N) in ``dtype`` for ``dequant_bias_residual``.
    The output is in ``dtype``, or fp32 for ``dequant_bias_gelu`` and
    ``dequant_bias_f32``.  On the card K is a multiple of 16, N of 8 and
    every tensor starts on 16 bytes (:func:`require_int8_pieces`)."""
    if epilogue not in _INT8_EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; use {sorted(_INT8_EPILOGUES)}")
    if (residual is None) != (epilogue != "dequant_bias_residual"):
        raise ValueError("residual is given exactly for the dequant_bias_residual epilogue")
    if not a_q.is_cuda:
        return gemm_int8_epilogue_plain(a_q, a_s, w_q, w_s, bias, epilogue, dtype, residual)
    name = "gemm_int8_epilogue"
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: activation dtype {dtype} not supported (float32 or bfloat16)")
    n, k = w_q.shape
    _require_on_card(name, torch.int8, a_q=a_q, w_q=w_q)
    _require_on_card(name, torch.float32, a_s=a_s, w_s=w_s, bias=bias)
    m = a_q.numel() // k
    if a_q.shape[-1] != k or a_s.numel() != m or w_s.shape != (n,) or bias.shape != (n,):
        raise ValueError(f"{name}: a_q {tuple(a_q.shape)}, a_s {tuple(a_s.shape)}, w_q "
                         f"{tuple(w_q.shape)}, w_s {tuple(w_s.shape)}, bias {tuple(bias.shape)} "
                         f"do not chain")
    out_dtype = torch.float32 if epilogue in _FP32_OUT_EPILOGUES else dtype
    out = torch.empty(*a_q.shape[:-1], n, dtype=out_dtype, device=a_q.device)
    tensors = dict(a_q=a_q, w_q=w_q, w_s=w_s, bias=bias)
    if residual is not None:
        _require_on_card(name, dtype, residual=residual)
        if residual.shape != out.shape:
            raise ValueError(f"{name}: residual {tuple(residual.shape)} != output "
                             f"{tuple(out.shape)}")
        tensors["residual"] = residual
    require_int8_pieces(name, k, n, tensors)
    lib = _build.load_library()
    _build.check(
        lib.gemm_int8_epilogue(
            _DTYPES[dtype], a_q.data_ptr(), a_s.data_ptr(), w_q.data_ptr(), w_s.data_ptr(),
            bias.data_ptr(), None if residual is None else residual.data_ptr(),
            out.data_ptr(), m, n, k, _INT8_EPILOGUES[epilogue], _stream(),
        ),
        name,
    )
    _count(name, epilogue)
    return out


# -- K3: the whole W8A8 block ------------------------------------------------------------


def _int8_block_chain(x, q, n_head, causal, length, ln_quant, quant, gemm, attention):
    """The cast points of ``_block_kernel_int8`` (``pallas_kernels.py:
    516-585``).  The fc output, the fp32 QuickGELU hidden, is the chain's
    largest intermediate (M x 4D x 4 bytes, ~620 MB for a ViT-B/16 image
    block at B=256); it is allocated per call."""
    d, dtype = x.shape[-1], x.dtype
    qkv = gemm(*ln_quant(x, q["ln1s"], q["ln1b"]), q["wqkv"], q["sqkv"], q["bqkv"],
               "dequant_bias", dtype)
    attn = attention(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], n_head, causal, length)
    x = gemm(*quant(attn), q["wo"], q["so"], q["bo"], "dequant_bias_residual", dtype,
             residual=x)
    hid = gemm(*ln_quant(x, q["ln2s"], q["ln2b"]), q["wfc"], q["sfc"], q["bfc"],
               "dequant_bias_gelu", dtype)
    return gemm(*quant(hid), q["wproj"], q["sproj"], q["bproj"], "dequant_bias_residual", dtype,
                residual=x)


def fused_transformer_block_int8_plain(x, qblock: dict, n_head: int, causal: bool = False,
                                       length: Optional[int] = None):
    """K3's plain version, with the TPU kernel's cast points."""
    _check_block_input(x, n_head, length)
    return _int8_block_chain(
        x, qblock, n_head, causal, length, layernorm_quant_rows_plain, quant_rows_plain,
        gemm_int8_epilogue_plain, fused_attention_packed_plain,
    )


def fused_transformer_block_int8(x, qblock: dict, n_head: int, causal: bool = False,
                                 length: Optional[int] = None):
    """K3: one CLIP residual block in W8A8 (``pallas_kernels.py:640``).

    ``x`` (B, L, D) in bf16 or fp32; ``qblock`` is one layer from
    :func:`quantize_block`.  The attention core runs in the activation
    dtype on ``attention_packed``, as K2's.  Same ``length=`` contract as
    :func:`fused_transformer_block`; L needs no padding.
    """
    if not x.is_cuda:
        return fused_transformer_block_int8_plain(x, qblock, n_head, causal, length)
    _check_block_input(x, n_head, length)
    _require_cuda("fused_transformer_block_int8", x.dtype, x=x)
    out = _int8_block_chain(
        x, qblock, n_head, causal, length, layernorm_quant_rows, quant_rows,
        gemm_int8_epilogue, attention_packed,
    )
    _count("fused_transformer_block_int8")
    return out


# -- the block-variant bench's own kernels ---------------------------------------------------


def qkv_sum_plain(qkv):
    """``q + k + v`` over the three column slices of ``(..., 3D)``, two adds
    in its dtype (``bench_block_variants.py:583``, ``:645``, ``:828``)."""
    d = qkv.shape[-1] // 3
    return qkv[..., :d] + qkv[..., d:2 * d] + qkv[..., 2 * d:]


def qkv_sum(qkv):
    """``csrc/qkv_sum.cu``: ``qkv`` (..., 3D) contiguous -> (..., D)."""
    if not qkv.is_cuda:
        return qkv_sum_plain(qkv)
    _require_cuda("qkv_sum", qkv.dtype, qkv=qkv)
    if qkv.shape[-1] % 3:
        raise ValueError(f"qkv_sum: last dim {qkv.shape[-1]} is not 3D")
    d = qkv.shape[-1] // 3
    out = torch.empty(*qkv.shape[:-1], d, dtype=qkv.dtype, device=qkv.device)
    rows = qkv.numel() // (3 * d)
    _build.check(
        _build.load_library().qkv_sum(_DTYPES[qkv.dtype], qkv.data_ptr(), out.data_ptr(), rows,
                                      d, _stream()),
        "qkv_sum",
    )
    _count("qkv_sum")
    return out


def _int8_codes(t, amax):
    """``clip(round(t * (127 / amax)), +-127)`` with a true division, kept in
    fp32 (``bench_block_variants.py:1030-1031``, ``:1048``)."""
    return torch.round(t * (torch.full_like(amax, 127.0) / amax)).clamp_(-127, 127)


def attention_int8_plain(q, k, v, n_head: int, length: Optional[int] = None, group: int = 1):
    """``make_kernel_int8s``'s attention core (``bench_block_variants.py:
    1023-1054``) over packed ``(B, L, D)`` q, k, v: per-row int8 q and k,
    an exact int32 score dot rescaled as ``(f32(s) * (q_amax * f32(scale /
    127))) * (k_amax * f32(1/127))``, keys >= ``length`` masked, fp32
    softmax, weights ``round(w * 127)``, v in int8 at one amax per head over
    each ``group`` of consecutive batch elements (all L rows, padded ones
    included: the TPU grid's block), an exact int32 PV dot and
    ``T(f32(o) * (v_amax / 16129))``."""
    b, l, d = q.shape
    if b % group:
        raise ValueError(f"attention_int8: batch {b} is not a multiple of group {group}")
    dh = d // n_head
    length = l if length is None else length
    qh, kh, vh = (_heads(t, n_head).float() for t in (q, k, v))  # (B, H, L, dh)
    q_amax = qh.abs().amax(dim=-1, keepdim=True).clamp_min(QUANT_FLOOR)
    k_amax = kh.abs().amax(dim=-1, keepdim=True).clamp_min(QUANT_FLOOR)
    # int32 sums, exact in float64
    s_int = torch.matmul(_int8_codes(qh, q_amax).double(),
                         _int8_codes(kh, k_amax).double().transpose(-1, -2)).float()
    s = s_int * (q_amax * (dh ** -0.5 / 127.0)) * (k_amax.transpose(-1, -2) * (1.0 / 127.0))
    s = s.masked_fill(torch.arange(l, device=q.device) >= length, -1e30)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w_q = torch.round(e / e.sum(dim=-1, keepdim=True) * 127.0)
    v_amax = vh.reshape(b // group, group, n_head, l, dh).abs().amax(dim=(1, 3, 4))
    v_amax = v_amax.clamp_min(QUANT_FLOOR).repeat_interleave(group, 0)[:, :, None, None]
    o_int = torch.matmul(w_q.double(), _int8_codes(vh, v_amax).double()).float()
    o = o_int * (v_amax / torch.tensor(127.0 * 127.0, device=q.device))
    return o.to(v.dtype).transpose(1, 2).reshape(b, l, d)


def attention_int8(q, k, v, n_head: int, length: Optional[int] = None, group: int = 1):
    """``csrc/attention_int8.cu`` on ``(B, L, D)`` views that share one row
    stride (the column slices of a fused QKV buffer).  ``group``: the batch
    elements that share one v scale per head (the TPU grid's block).  The
    kernel reads rows in 16-byte pieces: dh and the row stride are
    multiples of 8 elements and the views start on 16-byte boundaries, or
    it raises ``ValueError``."""
    if not q.is_cuda:
        return attention_int8_plain(q, k, v, n_head, length, group)
    b, l, d = q.shape
    dh, ld = _check_packed("attention_int8", q, k, v, n_head)
    length = l if length is None else length
    if not 1 <= length <= l:
        raise ValueError(f"length={length} must lie in [1, {l}]")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"attention_int8: head dim {dh} > {MAX_HEAD_DIM}")
    require_pieces("attention_int8", {"dh": dh, "row stride": ld}, {"q": q, "k": k, "v": v})
    if group < 1 or b % group or b > 65535:
        raise ValueError(f"attention_int8: batch {b} must be a multiple of group {group}, <= 65535")
    lib = _build.load_library()
    smem = lib.attention_int8_smem_bytes(l, dh)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"attention_int8: L={l}, dh={dh} needs {smem} B of shared memory")
    out = torch.empty(b, l, d, dtype=q.dtype, device=q.device)
    vamax = torch.empty(b // group, n_head, dtype=torch.float32, device=q.device)
    _build.check(
        lib.attention_int8(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), l * ld, dh, ld,
            out.data_ptr(), l * d, dh, d, b, l, n_head, dh, length, group, vamax.data_ptr(),
            dh ** -0.5 / 127.0, _stream(),
        ),
        "attention_int8",
    )
    _count("attention_int8")
    return out
