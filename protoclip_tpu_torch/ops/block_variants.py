"""The block-variant bench's blocks (S1), each a chain of the port's kernels.

Counterpart of the Pallas sites of ``scripts/bench_block_variants.py``: TPU
tuning copies of K2 and K3 that move their cast points.  Each site is one
function here, chained from the wrappers of :mod:`ops.kernels` in the
site's cast points:

- S1.a ``block_bf16`` (``make_kernel`` :60, ``build_stack_fn`` :304): the
  bf16 variants.  ``q_round`` scales q in bf16 before the scores (v1-v6),
  ``gelu_bf16`` evaluates QuickGELU op by op in bf16 (v2-v4), ``folded``
  drops the LayerNorm affine, which the host folded into the weights (v10).
- S1.b ``mlp_bf16`` (``bench_micro`` mlp_pallas :462): fc, bf16 QuickGELU,
  proj and residual, no LayerNorm.
- S1.c ``mlp_int8`` (int8mlp* :529): the int8 MLP half, three GELU forms.
- S1.d ``qkv_int8`` (int8qkv :589): int8 QKV and out-projection with
  q + k + v in place of attention.
- S1.e ``attn_bf16`` (attn_* :687): LN1, QKV, attention (softmax, no
  softmax, or q + k + v), out-projection.
- S1.f ``block_int8`` (``bench_int8`` :947 over ``make_kernel_int8`` :769
  and ``make_kernel_int8s`` :1000): the int8 variants, with the
  recip/static/cast quantizers, bf16 LayerNorm statistics, a bf16
  down-projection, and the int8 attention core of ``int8s``.

Variants that differ only in the TPU schedule (the grid group, head
batching or transposition, pipelining, MLP chunking, the bf16 preferred
element type) are the same function and share a chain; only ``int8s``'s
group changes the numbers (its v scale is per grid block).

``ops`` selects the kernels (:data:`KERNEL_OPS`, whose wrappers take their
plain versions for CPU tensors) or the plain versions on any device
(:data:`PLAIN_OPS`).  The host helpers are copies of the script's: the
geometry, the seeded draws, ``fold_ln_into_weights`` and
``_quant_cols_host``.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from protoclip_tpu_torch.ops import kernels as K

KERNEL_OPS = SimpleNamespace(
    ln=K.layernorm_rows, gemm=K.gemm_bias_epilogue, attention=K.attention_packed,
    ln_quant=K.layernorm_quant_rows, quant=K.quant_rows, gemm8=K.gemm_int8_epilogue,
    qkv_sum=K.qkv_sum, attention_int8=K.attention_int8,
)
PLAIN_OPS = SimpleNamespace(
    ln=K.layernorm_rows_plain, gemm=K.gemm_bias_epilogue_plain,
    attention=K.fused_attention_packed_plain, ln_quant=K.layernorm_quant_rows_plain,
    quant=K.quant_rows_plain, gemm8=K.gemm_int8_epilogue_plain, qkv_sum=K.qkv_sum_plain,
    attention_int8=K.attention_int8_plain,
)


# -- geometry and the seeded draws (bench_block_variants.py:26-35, :324-348) ---------------


@dataclass(frozen=True)
class Geometry:
    batch: int = 512
    length: int = 197   # L: valid rows; keys past it are masked
    padded: int = 200   # LP: rows of x, padded rows included
    width: int = 768    # D
    heads: int = 12     # H
    layers: int = 12
    group: int = 16     # G: the TPU grid's batch block


def geometry(env=None) -> Geometry:
    """The script's module constants: ViT-B/16 (B=512, L=197, D=768, H=12),
    ``$BENCH_GEOM=vitl`` for ViT-L/14 (B=128, L=257, D=1024, H=16), LP = L
    rounded up to 8, or to 16 with ``$BENCH_LP16``."""
    env = os.environ if env is None else env
    b, length, d, h = 512, 197, 768, 12
    if env.get("BENCH_GEOM") == "vitl":
        b, length, d, h = 128, 257, 1024, 16
    lp = -(-length // 8) * 8
    if env.get("BENCH_LP16"):
        lp = -(-length // 16) * 16
    return Geometry(b, length, lp, d, h)


def _draw(rng, shape, std, dtype):
    return torch.from_numpy(rng.standard_normal(shape) * std).to(dtype)


def draw_x(rng, geom: Geometry) -> torch.Tensor:
    """x (B, LP, D) in bf16: the first draw of every bench entry."""
    return _draw(rng, (geom.batch, geom.padded, geom.width), 0.1, torch.bfloat16)


def make_weights(rng, geom: Geometry) -> tuple:
    """The 12 stacked ``(LAYERS, ...)`` weights of ``make_weights`` (:324),
    in its order and draws: (wqkv, bqkv, wo, bo, ln1s, ln1b, ln2s, ln2b,
    wfc, bfc, wproj, bproj), bf16 with the LayerNorm parameters in fp32."""
    d = geom.width

    def r(*shape, dt=torch.bfloat16):
        return _draw(rng, (geom.layers,) + shape, 0.02, dt)

    f32 = torch.float32
    return (
        r(d, 3 * d), r(3 * d), r(d, d), r(d),
        r(d, dt=f32), r(d, dt=f32), r(d, dt=f32), r(d, dt=f32),
        r(d, 4 * d), r(4 * d), r(4 * d, d), r(d),
    )


@functools.lru_cache(maxsize=2)
def main_draws(geom: Geometry) -> Tuple[torch.Tensor, tuple]:
    """``default_rng(0)``: x, then the weights, as ``main`` (:354-356) and
    ``bench_int8`` (:926-928) draw them.  Cached: callers do not mutate."""
    rng = np.random.default_rng(0)
    return draw_x(rng, geom), make_weights(rng, geom)


@functools.lru_cache(maxsize=2)
def micro_draws(geom: Geometry, family: str) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``bench_micro``'s draws (:410-411 and each branch's own): x, then the
    stacked bf16 fc and proj matrices (``family="mlp"``) or QKV and out
    matrices (``"qkv"``)."""
    rng = np.random.default_rng(0)
    x = draw_x(rng, geom)
    d, n = geom.width, geom.layers
    if family == "mlp":
        shapes = ((n, d, 4 * d), (n, 4 * d, d))
    elif family == "qkv":
        shapes = ((n, d, 3 * d), (n, d, d))
    else:
        raise ValueError(f"unknown draw family {family!r}")
    return (x, *(_draw(rng, s, 0.02, torch.bfloat16) for s in shapes))


def fold_ln_into_weights(weights: tuple) -> tuple:
    """Fold the LN affine (scale s, bias b) into the following matmul (:336):
    ``(norm(x)*s + b) @ W + c == norm(x) @ (s[:,None]*W) + (b @ W + c)``,
    in fp32 and rounded back to each weight's dtype."""
    (wqkv, bqkv, wo, bo, ln1s, ln1b, ln2s, ln2b, wfc, bfc, wproj, bproj) = weights
    wqkv32, wfc32 = wqkv.float(), wfc.float()
    wqkv_f = (ln1s[:, :, None] * wqkv32).to(wqkv.dtype)
    bqkv_f = (bqkv.float() + torch.einsum("li,lio->lo", ln1b, wqkv32)).to(bqkv.dtype)
    wfc_f = (ln2s[:, :, None] * wfc32).to(wfc.dtype)
    bfc_f = (bfc.float() + torch.einsum("li,lio->lo", ln2b, wfc32)).to(bfc.dtype)
    return (wqkv_f, bqkv_f, wo, bo, ln1s, ln1b, ln2s, ln2b, wfc_f, bfc_f, wproj, bproj)


def quant_cols_host(w) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8 of an (in, out) matrix, in numpy
    (``_quant_cols_host`` :741): (int8 (in, out), fp32 scales (1, out))."""
    w = np.asarray(w, np.float32)
    amax = np.maximum(np.abs(w).max(axis=0, keepdims=True), 1e-6)
    scale = amax / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale


def quant_layer(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's (in, out) bf16 matrix -> the int8 GEMM's operands: codes
    stored (out, in), K-major, and fp32 scales (out,)."""
    q, s = quant_cols_host(w.float().numpy())
    return torch.from_numpy(q.T.copy()), torch.from_numpy(s.reshape(-1))


def dequantized_bf16(w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8h's down-projection weight ``T(T(w_q) * T(s))`` (:894), from the
    stored (out, in) codes, returned (in, out) for ``gemm_bias_epilogue``."""
    return (w_q.t().to(torch.bfloat16) * scale.to(torch.bfloat16)).contiguous()


def int8_layers(weights: tuple, layers: int, down_bf16: bool = False) -> list:
    """``bench_int8``'s per-layer operands (:931-961) from bf16 weights:
    (wqkv, sqkv, bqkv, wo, so, bo, ln1s, ln1b, ln2s, ln2b, wfc, sfc, bfc,
    wproj, sproj, bproj) with int8 matrices (out, in), fp32 scales and
    biases, plus int8h's bf16 down-projection weight where asked."""
    (wqkv, bqkv, wo, bo, ln1s, ln1b, ln2s, ln2b, wfc, bfc, wproj, bproj) = weights
    out = []
    for i in range(layers):
        qkv, o, fc, proj = (quant_layer(w[i]) for w in (wqkv, wo, wfc, wproj))
        layer = (*qkv, bqkv[i].float(), *o, bo[i].float(), ln1s[i], ln1b[i], ln2s[i], ln2b[i],
                 *fc, bfc[i].float(), *proj, bproj[i].float())
        if down_bf16:
            layer += (dequantized_bf16(*proj),)
        out.append(layer)
    return out


# -- the sites -----------------------------------------------------------------------------


# blocks of each site run on the card's kernels; each is a chain of the
# launches that ops.kernels.LAUNCHES counts
SITE_CALLS: Dict[str, int] = {
    "bench_block_bf16": 0,
    "bench_mlp_bf16": 0,
    "bench_mlp_int8": 0,
    "bench_qkv_int8": 0,
    "bench_attn_bf16": 0,
    "bench_block_int8": 0,
}


def reset_site_calls() -> None:
    for name in SITE_CALLS:
        SITE_CALLS[name] = 0


def site_calls() -> Dict[str, int]:
    return dict(SITE_CALLS)


def _site(name: str, x: torch.Tensor, ops) -> None:
    if ops is KERNEL_OPS and x.is_cuda:
        SITE_CALLS[name] += 1


def _split(qkv):
    d = qkv.shape[-1] // 3
    return qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]


def block_bf16(x, layer, n_head: int, length: int, q_round: bool = False,
               gelu_bf16: bool = False, folded: bool = False, ops=KERNEL_OPS):
    """S1.a: one bf16 residual block with the variant's cast points.  K2's
    chain, with ``q_round`` (``attention_packed`` mode), ``gelu_bf16``
    (``bias_gelu_bf16`` epilogue) and ``folded`` (LayerNorm without affine,
    ``ln_noaffine`` :80-85: scale 1 and bias 0 leave its bits unchanged)."""
    (wqkv, bqkv, wo, bo, ln1s, ln1b, ln2s, ln2b, wfc, bfc, wproj, bproj) = layer
    if folded:
        ln1s = ln2s = torch.ones_like(ln1s)
        ln1b = ln2b = torch.zeros_like(ln1b)
    qkv = ops.gemm(ops.ln(x, ln1s, ln1b), wqkv, bqkv, "bias")
    attn = ops.attention(*_split(qkv), n_head, False, length, "q_round" if q_round else "softmax")
    x1 = ops.gemm(attn, wo, bo, "bias_residual", residual=x)
    hid = ops.gemm(ops.ln(x1, ln2s, ln2b), wfc, bfc, "bias_gelu_bf16" if gelu_bf16 else "bias_gelu")
    out = ops.gemm(hid, wproj, bproj, "bias_residual", residual=x1)
    _site("bench_block_bf16", x, ops)
    return out


def mlp_bf16(x, layer, ops=KERNEL_OPS):
    """S1.b (mlp_pallas :444-459): T(acc + b) through QuickGELU in bf16,
    then T(x + T(T(acc) + b))."""
    wfc, bfc, wproj, bproj = layer
    hid = ops.gemm(x, wfc, bfc, "bias_gelu_bf16")
    out = ops.gemm(hid, wproj, bproj, "bias_residual", residual=x)
    _site("bench_mlp_bf16", x, ops)
    return out


def mlp_xla(x, layer):
    """micro:mlp_xla (:419-428), plain XLA in the script: plain PyTorch
    matrix products in bf16 (a library call, no kernel of the port)."""
    wfc, bfc, wproj, bproj = layer
    b, lp, d = x.shape
    h = x.reshape(b * lp, d) @ wfc + bfc
    h = h * torch.sigmoid(K._const(1.702, h) * h)
    return x + (h @ wproj + bproj).reshape(b, lp, d)


_INT8_GELU = {"bf16gelu": "dequant_bias_gelu_bf16", "nogelu": "dequant_bias_f32",
              "fp32gelu": "dequant_bias_gelu"}


def mlp_int8(x, layer, mode: str = "bf16gelu", ops=KERNEL_OPS):
    """S1.c (int8mlp* :509-526): fp32 LayerNorm quantized, int8 fc with the
    GELU ``mode`` (bf16 QuickGELU, none, fp32 QuickGELU), the hidden
    quantized, int8 proj and residual."""
    wfc, sfc, bfc, wproj, sproj, bproj, ln2s, ln2b = layer
    dtype = x.dtype
    hid = ops.gemm8(*ops.ln_quant(x, ln2s, ln2b), wfc, sfc, bfc, _INT8_GELU[mode], dtype)
    out = ops.gemm8(*ops.quant(hid), wproj, sproj, bproj, "dequant_bias_residual", dtype,
                    residual=x)
    _site("bench_mlp_int8", x, ops)
    return out


def qkv_int8(x, layer, ops=KERNEL_OPS):
    """S1.d (int8qkv :573-586): int8 QKV, q + k + v in place of attention,
    the sum quantized, int8 out-projection and residual."""
    wqkv, sqkv, bqkv, wo, so, bo, ln1s, ln1b = layer
    dtype = x.dtype
    qkv = ops.gemm8(*ops.ln_quant(x, ln1s, ln1b), wqkv, sqkv, bqkv, "dequant_bias", dtype)
    out = ops.gemm8(*ops.quant(ops.qkv_sum(qkv)), wo, so, bo, "dequant_bias_residual", dtype,
                    residual=x)
    _site("bench_qkv_int8", x, ops)
    return out


def attn_bf16(x, layer, n_head: int, length: int, kind: str = "softmax", ops=KERNEL_OPS):
    """S1.e (attn_* :628-684): LN1, QKV, then attention with q rounded
    (``softmax``), weights T(s * 0.005) over every key (``no_softmax``), or
    q + k + v (``noqkv``), out-projection and residual."""
    wqkv, bqkv, wo, bo, ln1s, ln1b = layer
    qkv = ops.gemm(ops.ln(x, ln1s, ln1b), wqkv, bqkv, "bias")
    if kind == "noqkv":
        attn = ops.qkv_sum(qkv)
    else:
        attn = ops.attention(*_split(qkv), n_head, False, length,
                             "no_softmax" if kind == "no_softmax" else "q_round")
    out = ops.gemm(attn, wo, bo, "bias_residual", residual=x)
    _site("bench_attn_bf16", x, ops)
    return out


def block_int8(x, layer, n_head: int, length: int, quant_hid: bool = True,
               skip_attn: bool = False, quant_scores: bool = False, gelu_bf16: bool = False,
               static_scales: bool = False, quant_mode: str = "dyn",
               ln_stats_bf16: bool = False, group: int = 16, ops=KERNEL_OPS):
    """S1.f: one W8A8 block of ``make_kernel_int8`` (:810-901) or, with
    ``quant_scores``, ``make_kernel_int8s`` (:1003-1075), whose quantizer,
    LayerNorm and MLP are K3's and whose attention core is int8 with one v
    scale per head and ``group`` of batch elements.  ``layer`` is one entry
    of :func:`int8_layers` (with the bf16 down-projection weight last when
    ``quant_hid`` is off)."""
    (wqkv, sqkv, bqkv, wo, so, bo, ln1s, ln1b, ln2s, ln2b,
     wfc, sfc, bfc, wproj, sproj, bproj) = layer[:16]
    dtype = x.dtype
    if quant_scores:  # make_kernel_int8s fixes all of these
        qmode, lnb, skip_attn, gelu_bf16, quant_hid = "dyn", False, False, False, True
    else:
        qmode, lnb = ("static" if static_scales else quant_mode), ln_stats_bf16
    if skip_attn:  # the noattn branch (:827-845): fp32 QuickGELU, hidden quantized
        gelu_bf16, quant_hid = False, True

    def ln_quant(t, s, b):
        return ops.ln_quant(t, s, b, mode=qmode, bf16_stats=lnb)

    qkv = ops.gemm8(*ln_quant(x, ln1s, ln1b), wqkv, sqkv, bqkv, "dequant_bias", dtype)
    if skip_attn:
        attn = ops.qkv_sum(qkv)
    elif quant_scores:
        attn = ops.attention_int8(*_split(qkv), n_head, length, group)
    else:
        attn = ops.attention(*_split(qkv), n_head, False, length, "q_round")
    x1 = ops.gemm8(*ops.quant(attn, qmode), wo, so, bo, "dequant_bias_residual", dtype,
                   residual=x)
    if gelu_bf16:
        epi = "dequant_bias_gelu_bf16"
    else:
        epi = "dequant_bias_gelu" if quant_hid else "dequant_bias_gelu_round"
    hid = ops.gemm8(*ln_quant(x1, ln2s, ln2b), wfc, sfc, bfc, epi, dtype)
    if quant_hid:
        out = ops.gemm8(*ops.quant(hid, qmode), wproj, sproj, bproj, "dequant_bias_residual",
                        dtype, residual=x1)
    else:  # the bf16 down-projection (:893-897)
        out = ops.gemm(hid, layer[16], bproj, "bias32_residual", residual=x1)
    _site("bench_block_int8", x, ops)
    return out


def run_stack(block, x: torch.Tensor, layers: list, batch: Optional[int] = None):
    """The 12-layer stack (``jax.lax.scan`` over the layers) on x, or on
    its first ``batch`` elements."""
    out = x if batch is None else x[:batch].contiguous()
    for layer in layers:
        out = block(out, layer)
    return out
