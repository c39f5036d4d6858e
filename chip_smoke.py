#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``protoclip_tpu_torch``) on one NVIDIA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, one JSON line each on stdout:

1. device  - require CUDA; the card's name and power limit from nvidia-smi.
2. build   - compile ``protoclip_tpu_torch/csrc/*.cu`` with nvcc (sm_90a);
             the registers and spills ptxas reports for the tensor-core
             attention and GEMM kernels.
3. check   - every CUDA kernel, and the K1, K2, K3 and K4 entries, against
             its plain PyTorch version on the card at the ViT-B/16, text,
             ViT-L/14 and ViT-B/32 block geometries; then the ragged edges
             of the bf16 attention (L = 1, 16, 17, 77 causal, 197, 257 at
             dh = 32, 64, 128, length < L, both bench modes, all three
             stride layouts) and of the GEMM (M = 8 x 197, K = 200, N = 192,
             each epilogue); of the int8 GEMM (M = 1, 8 x 197; K = 16 ...
             4096; N = 8, 192, 2304; each epilogue, bit-exact), of the
             quantizer (W = 8 ... 4096, every quantizer and LayerNorm)
             and of the int8 attention core (L = 1 ... 264, dh = 16 ...
             128, length < L, groups 1, 2, 4: bit-exact or within two
             steps of v_amax / 127, the moved outputs counted).
4. main    - zero-shot Proto-CLIP on ViT-B/16 at full width with random
             weights: memory banks, prototypes, the alpha/beta sweep and the
             accuracy, with the kernels' launch counts of that run, and the
             card's features held against the plain path in fp32 on the CPU.
5. main_int8 - the same run in the W8A8 serving mode ($PROTOCLIP_INT8:
             load_clip quantizes, every layer is K3), plus the serving encode
             (io.make_encode_fn) on a fixed uint8 batch, with its own launch
             counts, held against the same fp32 CPU features.
6. runner  - test-only Proto-CLIP on RN50 at full width (random weights,
             bf16) through the port's own entry points, on a synthetic
             caltech101 tree of JPEGs: ``train.runner.prepare_experiment``
             (the threaded loader, PIL decode and train/eval transforms,
             the ResNet image tower on cuDNN, K2 on every text layer, the
             feature caches in the reference's tree), a ``_v/_t/_a`` triple
             saved, then ``run(only_test=True)``, which must encode nothing
             (K2 launched 0 times) and whose ``test_acc_fixed`` must equal
             the accuracy of the cached features and the reloaded triple;
             RN50's card features held against the fp32 CPU path.
7. times   - each kernel (CUDA events around one call, and its device
             time: the same with the call queued behind a spinning kernel),
             its plain version, one PyTorch library call for the same
             function and the bound, at the main path's encode batches
             (images B=256, prompts B=1024), and the encode rates in bf16
             (K2) and int8 (K3), and RN50's image encode in bf16.
8. variants - the block-variant bench (``python -m protoclip_tpu_torch.
             scripts.bench_block_variants``, the port of
             scripts/bench_block_variants.py) over every variant at the full
             ViT-B/16 geometry (B=512, LP=200, 12 layers) and four at
             ViT-L/14: ms per stack, checksum, twin, bound and launches; each
             distinct chain held against its plain versions (the stack at
             B=16, layer 0's block and int8s's attention core at the full
             batch), twins held to their twin's checksum; then each of its
             modes, kernels and sites timed alone and held to its check rule
             at the bench geometry (variant_times).
9. kernels - the contract line: every ported kernel with the path or phase
             that launched it, its launches (by path, the runner's too),
             error, times and bound.

The bf16 paths of the two kernels that carry the blocks run on the tensor
cores: ``attention_packed.cu`` as mma.sync m16n8k16 (Q, K, V through
cp.async into shared memory, a two-pass softmax over the whole row with
the weights normalised before their bf16 rounding, P fed from registers)
and ``gemm_bias_epilogue.cu`` as wgmma m64n128k16 on tiles that TMA brings
through a 3-stage mbarrier ring, W read N-major through the descriptor's
transpose bit; fp32 stays on the exact SIMT kernels.  The W8A8 block's
GEMM (``gemm_int8_epilogue.cu``) runs wgmma m64n128k32 s8 on the same ring,
for both activation dtypes, and its quantizer (``quant_rows.cu``) reads
each row from device memory once.  The bench's int8 attention core
(``attention_int8.cu``) runs its score and PV products as mma.sync
m16n8k32 s8, for both activation dtypes.

The last line is ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero before it; without CUDA the script exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense): bound = max(bytes /
# memory rate, flops / compute rate).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}

# Acceptance bars for a kernel against its plain version on the card:
# max|diff| / max|plain| and the flattened cosine.
BARS = {"bfloat16": (1e-2, 0.9999), "float32": (1e-5, 0.9999)}
# K3's block: a quantization step is amax/127, and LayerNorm and attention
# sum in another order than the plain version, so an int8 code on a rounding
# tie may move one step; K2's fp32 bar does not apply.
INT8_BLOCK_BARS = {"bfloat16": (2e-2, 0.9999), "float32": (1e-2, 0.99999)}

GEOMETRIES = {  # name: (L, D, heads, causal)
    "vit_b16": (197, 768, 12, False),
    "text": (77, 512, 8, True),
    "vit_l14": (257, 1024, 16, False),
    "vit_b32": (50, 768, 12, False),
}
CHECK_BATCH = 8


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# -- 1. device -----------------------------------------------------------------


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    info = {
        "phase": "device",
        "nvidia_smi": smi,
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
    }
    emit(info)
    return info


# -- 2. build ------------------------------------------------------------------


TENSOR_CORE_KERNELS = ("attention_bf16_mma", "gemm_bf16_wgmma", "gemm_s8_wgmma",
                       "attention_s8_mma")
# builtin types (one letter in the Itanium mangling) that the kernels' templates take
MANGLED_BUILTINS = {"f": "float"}


def template_args(mangled, name):
    """The template arguments of kernel ``name`` in its mangled symbol:
    integers (``Li64E``, ``Lin1E``), named types (``13__nv_bfloat16``) and
    builtin types (``f``), in order."""
    import re

    i = mangled.index(name + "I") + len(name) + 1
    args = []
    while mangled[i] != "E":
        m = re.match(r"L[ij](n?)(\d+)E", mangled[i:])
        if m:
            args.append(("-" if m.group(1) else "") + m.group(2))
            i += m.end()
            continue
        m = re.match(r"\d+", mangled[i:])
        if m:
            start = i + m.end()
            args.append(mangled[start:start + int(m.group())])
            i = start + int(m.group())
            continue
        args.append(MANGLED_BUILTINS[mangled[i]])
        i += 1
    return args


def ptxas_usage(log):
    """{kernel<template args>: {"registers": n, "spill_bytes": n}} of the
    tensor-core kernels, from nvcc's ``-Xptxas -v`` lines in the build log."""
    import re

    usage, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = next((k for k in TENSOR_CORE_KERNELS if k + "I" in m.group(1)), None)
            entry = None if name is None else (
                name + "<" + ",".join(template_args(m.group(1), name)) + ">")
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            usage.setdefault(entry, {})["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage.setdefault(entry, {})["registers"] = int(m.group(1))
    return usage


def phase_build():
    from protoclip_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build(force=True)
    _build.load_library()
    seconds = round(time.perf_counter() - t0, 3)
    usage = ptxas_usage((_build.BUILD_DIR / "build.log").read_text())
    require(all(any(k.startswith(name) for k in usage) for name in TENSOR_CORE_KERNELS),
            f"no ptxas report for the tensor-core kernels: {sorted(usage)}")
    emit({"phase": "build", "seconds": seconds, "library": str(_build.BUILD_DIR / _build.LIB_NAME),
          "ptxas": usage})


# -- 3. kernels against their plain versions -----------------------------------


def _random_block(np_rng, d, dtype, device, torch):
    """One layer with CLIP's init scale and non-trivial LN and biases."""

    def t(a, dt=dtype):
        return torch.from_numpy(a.astype("float32")).to(device=device, dtype=dt)

    def randn(*shape, std=1.0):
        return np_rng.standard_normal(shape, dtype="float32") * std

    return {
        "ln_1": {"scale": t(1 + randn(d, std=0.1), torch.float32),
                 "bias": t(randn(d, std=0.1), torch.float32)},
        "attn": {"wqkv": t(randn(d, 3 * d, std=d ** -0.5)), "bqkv": t(randn(3 * d, std=0.02)),
                 "wo": t(randn(d, d, std=d ** -0.5 * 0.2)), "bo": t(randn(d, std=0.02))},
        "ln_2": {"scale": t(1 + randn(d, std=0.1), torch.float32),
                 "bias": t(randn(d, std=0.1), torch.float32)},
        "mlp": {"w_fc": t(randn(d, 4 * d, std=(2 * d) ** -0.5)),
                "b_fc": t(randn(4 * d, std=0.02)),
                "w_proj": t(randn(4 * d, d, std=d ** -0.5 * 0.2)),
                "b_proj": t(randn(d, std=0.02))},
    }


def compare(kernel_out, plain_out):
    """(max|diff| / max|plain|, flattened cosine, max|diff|)."""
    a = kernel_out.double().flatten()
    b = plain_out.double().flatten()
    diff = float((a - b).abs().max())
    rel = diff / max(float(b.abs().max()), 1e-30)
    cos = float((a @ b) / (a.norm() * b.norm()).clamp_min(1e-300))
    return rel, cos, diff


def bars_agreement(out, ref, bars):
    """Within (rel, cos) bars: max|diff| / max|plain| below the first,
    flattened cosine above the second."""
    rel, cos, diff = compare(out, ref)
    lim_rel, lim_cos = bars
    return {"rel": rel, "cos": cos, "max_abs_err": diff, "ok": rel < lim_rel and cos > lim_cos}


def exact_agreement(outs, refs):
    """Bit-exact: every output tensor equal to the plain version's."""
    import torch

    equal = all(torch.equal(o, r) for o, r in zip(outs, refs))
    diff = max(float((o.double() - r.double()).abs().max()) for o, r in zip(outs, refs))
    return {"bit_exact": equal, "max_abs_err": diff, "ok": equal}


def ln_quant_agreement(got, want, bf16_stats=False):
    """LN statistics sum in another order: int8 codes equal in >= 99.9% of
    entries, never more than one step apart, scales within 1e-6.  With
    ``bf16_stats`` the mean and variance are rounded to bf16, and a sum on
    a rounding tie moves its row's scale by up to one bf16 ulp: scales
    within 1e-6 in >= 99.9% of rows and none more than 2^-7 apart."""
    (q, sc), (rq, rsc) = got, want
    step = (q.int() - rq.int()).abs()
    equal_share = float((step == 0).float().mean())
    rel = (sc - rsc).abs() / rsc
    scale_rel = float(rel.max())
    scale_share = float((rel <= 1e-6).float().mean())
    scales_ok = scale_rel <= 1e-6 or (bf16_stats and scale_share >= 0.999
                                      and scale_rel <= 2.0 ** -7)
    return {"max_step": int(step.max()), "equal_share": equal_share, "scale_rel": scale_rel,
            "scale_equal_share": scale_share, "max_abs_err": float(step.max()),
            "ok": int(step.max()) <= 1 and equal_share >= 0.999 and scales_ok}


def ulp_agreement(out, ref):
    """QuickGELU op by op in T: the card's expf and PyTorch's may differ by
    an fp32 ulp before rounding, so >= 99.9% of outputs equal and none more
    than one ulp of T off."""
    steps = ulp_steps(out, ref)
    equal_share = float((steps == 0).float().mean())
    return {"max_ulps": int(steps.max()), "equal_share": equal_share,
            "max_abs_err": _max_abs_err(out, ref),
            "ok": int(steps.max()) <= 1 and equal_share >= 0.999}


def int8_attention_agreement(out, ref, step):
    """``attention_int8``: bit-exact, or, where the softmax sums in another
    order than the plain version move a weight code a step on a rounding
    tie, no output more than two steps (``step`` = v_amax / 127) off and a
    cosine above 0.9999 (tests/test_torch_cuda.py's bar); ``moved`` counts
    the outputs that differ."""
    import torch

    _, cos, diff = compare(out, ref)
    exact = bool(torch.equal(out, ref))
    return {"bit_exact": exact, "moved": int((out != ref).sum()), "max_abs_err": diff,
            "max_steps": diff / step, "cos": cos,
            "ok": exact or (diff <= 2 * step and cos > 0.9999)}


def int8_attention_rule(v):
    """The rule of :func:`agreement` for ``attention_int8`` with v: one step
    is v's largest |value| / 127 (each group's v_amax is at most that)."""
    return ("int8_attention", float(v.abs().max()) / 127)


def agreement(out, ref, rule):
    """``out`` against ``ref`` by ``rule``: "exact", "ulp", "ln_quant",
    "ln_quant_bf16_stats", ("int8_attention", step) or a (rel, cos) pair of
    bars.  Tuples are a kernel's several outputs."""
    if rule == "exact":
        return exact_agreement(*((out, ref) if isinstance(out, tuple) else ([out], [ref])))
    if isinstance(rule, tuple) and rule[0] == "int8_attention":
        return int8_attention_agreement(out, ref, rule[1])
    if rule in ("ln_quant", "ln_quant_bf16_stats"):
        return ln_quant_agreement(out, ref, bf16_stats=rule == "ln_quant_bf16_stats")
    if rule == "ulp":
        return ulp_agreement(out, ref)
    return bars_agreement(out, ref, rule)


def phase_check(torch, np):
    from protoclip_tpu_torch.ops import kernels as K

    device = torch.device("cuda")
    np_rng = np.random.default_rng(0)
    rows = []

    def dname(dtype):
        return str(dtype).replace("torch.", "")

    def add(kernel, geom, dtype, result, **extra):
        rows.append({"kernel": kernel, "geometry": geom, "dtype": dname(dtype), **result,
                     **extra})

    def record(kernel, geom, dtype, out, ref, bars=BARS, **extra):
        torch.cuda.synchronize()
        add(kernel, geom, dtype, bars_agreement(out, ref, bars[dname(dtype)]), **extra)

    def record_exact(kernel, geom, dtype, outs, refs, **extra):
        torch.cuda.synchronize()
        add(kernel, geom, dtype, exact_agreement(outs, refs), **extra)

    def record_ln_quant(geom, dtype, got, want, kernel="layernorm_quant_rows", **extra):
        torch.cuda.synchronize()
        add(kernel, geom, dtype, ln_quant_agreement(got, want), **extra)

    def record_ulp(kernel, geom, dtype, out, ref, **extra):
        torch.cuda.synchronize()
        add(kernel, geom, dtype, ulp_agreement(out, ref), **extra)

    def record_rule(kernel, geom, dtype, out, ref, rule, **extra):
        torch.cuda.synchronize()
        add(kernel, geom, dtype, agreement(out, ref, rule), **extra)

    for geom, (L, D, H, causal) in GEOMETRIES.items():
        for dtype in (torch.bfloat16, torch.float32):
            p = _random_block(np_rng, D, dtype, device, torch)

            def randn(*shape, dt=dtype):
                t = torch.from_numpy(np_rng.standard_normal(shape, dtype="float32"))
                return t.to(device=device, dtype=dt)

            x = randn(CHECK_BATCH, L, D)
            # layernorm_rows
            record("layernorm_rows", geom, dtype,
                   K.layernorm_rows(x, p["ln_1"]["scale"], p["ln_1"]["bias"]),
                   K.layernorm_rows_plain(x, p["ln_1"]["scale"], p["ln_1"]["bias"]))
            # the four block GEMMs with their epilogues
            h = K.layernorm_rows_plain(x, p["ln_1"]["scale"], p["ln_1"]["bias"])
            hid_in = randn(CHECK_BATCH, L, 4 * D)
            cases = (
                ("qkv", h, p["attn"]["wqkv"], p["attn"]["bqkv"], "bias", None),
                ("out_proj", h, p["attn"]["wo"], p["attn"]["bo"], "bias_residual", x),
                ("fc", h, p["mlp"]["w_fc"], p["mlp"]["b_fc"], "bias_gelu", None),
                ("proj", hid_in, p["mlp"]["w_proj"], p["mlp"]["b_proj"], "bias_residual", x),
            )
            for tag, a, w, b, epi, res in cases:
                record("gemm_bias_epilogue", geom, dtype,
                       K.gemm_bias_epilogue(a, w, b, epi, residual=res),
                       K.gemm_bias_epilogue_plain(a, w, b, epi, residual=res), gemm=tag)
            # attention on the K2 layout (column slices of one QKV buffer),
            # whole and with a padded tail masked by length
            qkv = K.gemm_bias_epilogue_plain(h, p["attn"]["wqkv"], p["attn"]["bqkv"], "bias")
            sl = (qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:])
            for length in (L, L - 5):
                record("attention_packed", geom, dtype,
                       K.attention_packed(*sl, H, causal, length),
                       K.fused_attention_packed_plain(*sl, H, causal, length), length=length)
            # K1 entry: three separate (B, L, D) tensors
            q, k, v = (t.contiguous() for t in sl)
            record("fused_attention_packed", geom, dtype,
                   K.fused_attention_packed(q, k, v, H, causal),
                   K.fused_attention_packed_plain(q, k, v, H, causal))
            # K4 entry: head-major (B, H, L, dh) tensors
            qh, kh, vh = (t.reshape(CHECK_BATCH, L, H, D // H).transpose(1, 2).contiguous()
                          for t in sl)
            record("fused_attention", geom, dtype, K.fused_attention(qh, kh, vh, causal),
                   K.fused_attention_plain(qh, kh, vh, causal))
            # K2 entry, whole and pre-padded with length
            record("fused_transformer_block", geom, dtype,
                   K.fused_transformer_block(x, p, H, causal),
                   K.fused_transformer_block_plain(x, p, H, causal))
            xp = torch.nn.functional.pad(x, (0, 0, 0, 3))
            record("fused_transformer_block", geom, dtype,
                   K.fused_transformer_block(xp, p, H, causal, length=L),
                   K.fused_transformer_block_plain(xp, p, H, causal, length=L), length=L)
            # K3 pieces: quant_rows (mode b) on the attention output and the
            # fp32 hidden, and the three int8 epilogues, bit-exact; the
            # LN quantizer (mode a) to its rule
            qb = K.quantize_block(p)
            attn = K.fused_attention_packed_plain(*sl, H, causal)
            hid32 = randn(CHECK_BATCH, L, 4 * D, dt=torch.float32)
            for tag, t in (("attn", attn), ("hidden_fp32", hid32)):
                record_exact("quant_rows", geom, dtype, K.quant_rows(t), K.quant_rows_plain(t),
                             input=tag)
            record_ln_quant(geom, dtype, K.layernorm_quant_rows(x, qb["ln1s"], qb["ln1b"]),
                            K.layernorm_quant_rows_plain(x, qb["ln1s"], qb["ln1b"]))
            h_q = K.layernorm_quant_rows_plain(x, qb["ln1s"], qb["ln1b"])
            a_q = K.quant_rows_plain(attn)
            hid_q = K.quant_rows_plain(hid32)
            int8_cases = (
                ("qkv", h_q, "qkv", "dequant_bias", None),
                ("out_proj", a_q, "o", "dequant_bias_residual", x),
                ("fc", h_q, "fc", "dequant_bias_gelu", None),
                ("proj", hid_q, "proj", "dequant_bias_residual", x),
            )
            for tag, (aq, as_), wname, epi, res in int8_cases:
                args = (aq, as_, qb["w" + wname], qb["s" + wname], qb["b" + wname], epi, dtype)
                record_exact("gemm_int8_epilogue", geom, dtype,
                             [K.gemm_int8_epilogue(*args, residual=res)],
                             [K.gemm_int8_epilogue_plain(*args, residual=res)], gemm=tag)
            # K3 entry, whole and pre-padded with length
            record("fused_transformer_block_int8", geom, dtype,
                   K.fused_transformer_block_int8(x, qb, H, causal),
                   K.fused_transformer_block_int8_plain(x, qb, H, causal), INT8_BLOCK_BARS)
            record("fused_transformer_block_int8", geom, dtype,
                   K.fused_transformer_block_int8(xp, qb, H, causal, length=L),
                   K.fused_transformer_block_int8_plain(xp, qb, H, causal, length=L),
                   INT8_BLOCK_BARS, length=L)
            # the block-variant bench's modes and kernels
            for mode in ("q_round", "no_softmax"):
                for length in (L, L - 5):
                    record("attention_packed." + mode, geom, dtype,
                           K.attention_packed(*sl, H, causal, length, mode),
                           K.fused_attention_packed_plain(*sl, H, causal, length, mode),
                           length=length)
            for group in (1, 2):
                record_rule("attention_int8", geom, dtype, K.attention_int8(*sl, H, L - 5, group),
                            K.attention_int8_plain(*sl, H, L - 5, group),
                            int8_attention_rule(sl[2]), group=group)
            record_exact("qkv_sum", geom, dtype, [K.qkv_sum(qkv)], [K.qkv_sum_plain(qkv)])
            # the fp32 accumulator sums in another order than the plain
            # version, so T(acc + b) may sit an ulp away before QuickGELU:
            # the GEMM's bars, as bias_gelu (the int8 epilogue's exact
            # accumulator meets the ulp rule below)
            fc = (h, p["mlp"]["w_fc"], p["mlp"]["b_fc"], "bias_gelu_bf16")
            record("gemm_bias_epilogue.bias_gelu_bf16", geom, dtype,
                   K.gemm_bias_epilogue(*fc), K.gemm_bias_epilogue_plain(*fc))
            w_down = (qb["wproj"].t().to(dtype) * qb["sproj"].to(dtype)).contiguous()
            down = (hid_in, w_down, qb["bproj"], "bias32_residual")
            record("gemm_bias_epilogue.bias32_residual", geom, dtype,
                   K.gemm_bias_epilogue(*down, residual=x),
                   K.gemm_bias_epilogue_plain(*down, residual=x))
            for mode in ("recip", "static", "cast"):
                for tag, t in (("attn", attn), ("hidden_fp32", hid32)):
                    record_exact("quant_rows." + mode, geom, dtype, K.quant_rows(t, mode),
                                 K.quant_rows_plain(t, mode), input=tag)
                record_ln_quant(geom, dtype, K.layernorm_quant_rows(x, qb["ln1s"], qb["ln1b"], mode=mode),
                                K.layernorm_quant_rows_plain(x, qb["ln1s"], qb["ln1b"], mode=mode),
                                kernel="layernorm_quant_rows." + mode)
            record_ln_quant(geom, dtype,
                            K.layernorm_quant_rows(x, qb["ln1s"], qb["ln1b"], bf16_stats=True),
                            K.layernorm_quant_rows_plain(x, qb["ln1s"], qb["ln1b"],
                                                         bf16_stats=True),
                            kernel="layernorm_quant_rows.bf16_stats")
            for epi in ("dequant_bias_gelu_bf16", "dequant_bias_f32", "dequant_bias_gelu_round"):
                args = (*h_q, qb["wfc"], qb["sfc"], qb["bfc"], epi, dtype)
                got, want = K.gemm_int8_epilogue(*args), K.gemm_int8_epilogue_plain(*args)
                if epi == "dequant_bias_gelu_bf16":
                    record_ulp("gemm_int8_epilogue." + epi, geom, dtype, got, want)
                else:
                    record_exact("gemm_int8_epilogue." + epi, geom, dtype, [got], [want])
            del p, qb, x, xp, h, hid_in, qkv, sl, q, k, v, qh, kh, vh, attn, hid32
            torch.cuda.empty_cache()
    check_edges(torch, np_rng, device, record)
    check_int8_edges(torch, np_rng, device, record_rule)
    check_int8_attention_edges(torch, np_rng, device, record_rule)
    for r in rows:
        emit({"phase": "check", **r})
    bad = [r for r in rows if not r["ok"]]
    require(not bad, f"{len(bad)} kernel checks failed: {bad}")
    emit({"phase": "check", "cases": len(rows), "all_ok": True})
    return rows


# (L, causal) and head dims of the attention's edges: one row, a 16-key
# tile and one past it, the text block, the image lengths
EDGE_LENGTHS = ((1, False), (16, False), (17, False), (77, True), (197, False), (257, False))
EDGE_HEAD_DIMS = (32, 64, 128)
EDGE_HEADS = 2


def check_edges(torch, np_rng, device, record):
    """The ragged edges of the tensor-core attention (``attention_packed``
    at every mode and length < L on QKV slices, the K1 and K4 entries) and
    of the GEMM (M = 8 x 197, K = 200, N = 192: no dimension a multiple of
    its tile, each epilogue), at the check phase's bars."""
    from protoclip_tpu_torch.ops import kernels as K

    for dtype in (torch.bfloat16, torch.float32):
        def randn(*shape, std=1.0, dt=dtype):
            t = torch.from_numpy(np_rng.standard_normal(shape, dtype="float32") * std)
            return t.to(device=device, dtype=dt)

        for (L, causal), dh in ((lc, dh) for lc in EDGE_LENGTHS for dh in EDGE_HEAD_DIMS):
            if dtype == torch.float32 and L == 257 and dh == 128:
                continue  # beyond the exact fp32 kernel's shared memory
            H, geom = EDGE_HEADS, f"edge_L{L}_dh{dh}"
            d = H * dh
            qkv = randn(3, L, 3 * d)
            sl = (qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:])
            length = max(1, L - 5)
            for mode in ("softmax", "q_round", "no_softmax"):
                name = "attention_packed" + ("" if mode == "softmax" else "." + mode)
                record(name, geom, dtype, K.attention_packed(*sl, H, causal, length, mode),
                       K.fused_attention_packed_plain(*sl, H, causal, length, mode),
                       length=length, causal=causal)
            q, k, v = (t.contiguous() for t in sl)
            record("fused_attention_packed", geom, dtype, K.fused_attention_packed(q, k, v, H, causal),
                   K.fused_attention_packed_plain(q, k, v, H, causal), causal=causal)
            qh, kh, vh = (t.reshape(3, L, H, dh).transpose(1, 2).contiguous() for t in sl)
            record("fused_attention", geom, dtype, K.fused_attention(qh, kh, vh, causal),
                   K.fused_attention_plain(qh, kh, vh, causal), causal=causal)
        m, kk, n = 8 * 197, 200, 192
        a, w = randn(8, 197, kk), randn(kk, n, std=kk ** -0.5)
        res = randn(8, 197, n)
        for epi in ("bias", "bias_residual", "bias_gelu", "bias_gelu_bf16", "bias32_residual"):
            bias = randn(n, std=0.1, dt=torch.float32 if epi == "bias32_residual" else dtype)
            r = res if epi in ("bias_residual", "bias32_residual") else None
            name = "gemm_bias_epilogue" + ("." + epi if epi in ("bias_gelu_bf16", "bias32_residual")
                                           else "")
            record(name, f"edge_M{m}_K{kk}_N{n}", dtype, K.gemm_bias_epilogue(a, w, bias, epi, r),
                   K.gemm_bias_epilogue_plain(a, w, bias, epi, r), gemm=epi)


# the int8 GEMM's edges: one row and a ragged 8 x 197; K from one 16-byte
# TMA row to 4096 (208: a ragged 128-byte K step); N one 8-column piece,
# half a tile and the ViT-B/16 QKV width
INT8_EDGE_M = (1, 8 * 197)
INT8_EDGE_K = (16, 208, 640, 3072, 4096)
INT8_EDGE_N = (8, 192, 2304)
# quant_rows.cu's width classes (a warp a row up to 512 bytes, a block a row
# above), the RN50x4 text widths 640 and 2560, and a row count that is no
# multiple of a block's four rows
QUANT_EDGE_WIDTHS = (8, 200, 640, 768, 2560, 3072, 4096)
QUANT_EDGE_ROWS = 8 * 197 + 3


def check_int8_edges(torch, np_rng, device, record_rule):
    """The ragged edges of the s8 wgmma GEMM (every M x K x N above, every
    epilogue, bf16 and fp32: bit-exact, the bf16 QuickGELU within an ulp)
    and of the one-read quantizer (every width above, every quantizer,
    without LayerNorm bit-exact, with it, f32 or bf16 statistics, to its
    step rule)."""
    from protoclip_tpu_torch.ops import kernels as K

    def on_card(a, dt=torch.float32):
        return torch.from_numpy(a).to(device=device, dtype=dt)

    for m, k, n in ((m, k, n) for m in INT8_EDGE_M for k in INT8_EDGE_K for n in INT8_EDGE_N):
        a_q = on_card(np_rng.integers(-127, 128, (m, k), dtype="int8"), torch.int8)
        w_q = on_card(np_rng.integers(-127, 128, (n, k), dtype="int8"), torch.int8)
        a_s = on_card((np_rng.random((m, 1), dtype="float32") + 0.5) / 127)
        w_s = on_card((np_rng.random(n, dtype="float32") + 0.5) / (127 * k ** 0.5))
        bias = on_card(np_rng.standard_normal(n, dtype="float32") * 0.1)
        res32 = np_rng.standard_normal((m, n), dtype="float32")
        for dtype in (torch.bfloat16, torch.float32):
            for epi in K._INT8_EPILOGUES:
                res = on_card(res32, dtype) if epi == "dequant_bias_residual" else None
                args = (a_q, a_s, w_q, w_s, bias, epi, dtype)
                name = "gemm_int8_epilogue" + ("" if epi in K._MAIN_MODES else "." + epi)
                record_rule(name, f"edge_M{m}_K{k}_N{n}", dtype,
                            K.gemm_int8_epilogue(*args, residual=res),
                            K.gemm_int8_epilogue_plain(*args, residual=res),
                            "ulp" if epi == "dequant_bias_gelu_bf16" else "exact", gemm=epi)
    rows = QUANT_EDGE_ROWS
    for w in QUANT_EDGE_WIDTHS:
        scale = on_card(1 + 0.1 * np_rng.standard_normal(w, dtype="float32"))
        bias = on_card(0.1 * np_rng.standard_normal(w, dtype="float32"))
        x32 = np_rng.standard_normal((rows, w), dtype="float32") * 3 + 0.5
        for dtype in (torch.bfloat16, torch.float32):
            x, geom = on_card(x32, dtype), f"edge_rows{rows}_W{w}"
            for mode in K._QUANT_MODES:
                sub = "" if mode == "dyn" else "." + mode
                record_rule("quant_rows" + sub, geom, dtype, K.quant_rows(x, mode),
                            K.quant_rows_plain(x, mode), "exact")
                record_rule("layernorm_quant_rows" + sub, geom, dtype,
                            K.layernorm_quant_rows(x, scale, bias, mode=mode),
                            K.layernorm_quant_rows_plain(x, scale, bias, mode=mode), "ln_quant")
                record_rule("layernorm_quant_rows.bf16_stats", geom, dtype,
                            K.layernorm_quant_rows(x, scale, bias, mode=mode, bf16_stats=True),
                            K.layernorm_quant_rows_plain(x, scale, bias, mode=mode,
                                                         bf16_stats=True),
                            "ln_quant_bf16_stats", qmode=mode)
        torch.cuda.empty_cache()


# the int8 attention core's edges: one row, a 16-row warp tile and one past
# it, the text length, the bench's padded image rows and ViT-L/14's 257 and
# 264 (no multiple of the 32-key step); head widths from one 16-byte piece
# of bf16 to 128 (zero-padded to a 32-byte k-step)
INT8_ATTENTION_EDGE_L = (1, 15, 16, 17, 77, 200, 257, 264)
INT8_ATTENTION_EDGE_DH = (16, 32, 64, 128)


def check_int8_attention_edges(torch, np_rng, device, record_rule):
    """The ragged edges of the s8 tensor-core attention core
    (``attention_int8`` at every L and dh above, length = L and L - 5, a v
    scale per 1, 2 and 4 batch elements, bf16 and fp32): bit-exact, or
    within two steps of v_amax / 127 with the moved outputs counted."""
    from protoclip_tpu_torch.ops import kernels as K

    heads, batch = 2, 4
    for L, dh in ((L, dh) for L in INT8_ATTENTION_EDGE_L for dh in INT8_ATTENTION_EDGE_DH):
        d = heads * dh
        qkv32 = np_rng.standard_normal((batch, L, 3 * d), dtype="float32") * 2
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.from_numpy(qkv32).to(device=device, dtype=dtype)
            sl = (qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:])
            for length in sorted({L, max(1, L - 5)}):
                for group in (1, 2, 4):
                    record_rule("attention_int8", f"edge_L{L}_dh{dh}", dtype,
                                K.attention_int8(*sl, heads, length, group),
                                K.attention_int8_plain(*sl, heads, length, group),
                                int8_attention_rule(sl[2]), length=length, group=group)


# -- 4-5. the main paths, bf16 and int8 ---------------------------------------------

SEED = 0
N_CLASS, SHOTS, AUGMENT, N_EVAL = 10, 4, 2, 40
IMAGE_BATCH, TEXT_BATCH = 32, 16
TEMPLATES = ["a photo of a {}.", "a close-up photo of the {}.", "art of the {}."]
SOT_ID, EOT_ID = 49406, 49407


def synthetic_tokenize(prompts, context_length=77):
    """Stands in for the BPE tokenizer, whose vocab file is not in the
    repository: SOT, one deterministic id per word, EOT."""
    import numpy as np

    out = np.zeros((len(prompts), context_length), np.int32)
    for i, prompt in enumerate(prompts):
        ids = [sum(ord(ch) * 31 ** k for k, ch in enumerate(w)) % 49000 + 1 for w in prompt.split()]
        row = [SOT_ID] + ids + [EOT_ID]
        out[i, :len(row)] = row
    return out


def coloured_images(np_rng, colours, per_class, px):
    """Class-coloured uint8 images: each class's colour plus noise."""
    import numpy as np

    labels = np.repeat(np.arange(len(colours)), per_class)
    noise = np_rng.integers(0, 56, (len(labels), px, px, 3))
    return (colours[labels][:, None, None, :] + noise).astype(np.uint8), labels


@contextlib.contextmanager
def int8_mode():
    """$PROTOCLIP_INT8 on for the block, as the serving mode sets it."""
    before = os.environ.get("PROTOCLIP_INT8")
    os.environ["PROTOCLIP_INT8"] = "1"
    try:
        yield
    finally:
        if before is None:
            del os.environ["PROTOCLIP_INT8"]
        else:
            os.environ["PROTOCLIP_INT8"] = before


def make_data(np, px):
    """The run's images, all from the seed: support, val and test splits."""
    np_rng = np.random.default_rng(SEED)
    colours = np_rng.integers(0, 200, (N_CLASS, 3))
    train = coloured_images(np_rng, colours, SHOTS, px)
    eval_x, eval_y = coloured_images(np_rng, colours, 2 * N_EVAL // N_CLASS, px)
    order = np_rng.permutation(len(eval_y))
    val = (eval_x[order[:N_EVAL]], eval_y[order[:N_EVAL]])
    test = (eval_x[order[N_EVAL:]], eval_y[order[N_EVAL:]])
    return {"train": train, "val": val, "test": test,
            "classnames": [f"class_{c}" for c in range(N_CLASS)]}


def run_zero_shot(torch, np, cfg, params, data, serving=None):
    """Zero-shot Proto-CLIP through the user's entry points: banks, cached
    features, prototypes, the 11 x 29 sweep and the accuracy.  The launch
    counts are set to 0 just before and read just after; ``serving(calls)``,
    where given, runs inside that window.  Returns (summary, counts)."""
    from protoclip_tpu_torch.core import accuracy, from_arrays
    from protoclip_tpu_torch.data import ArrayLoader, normalize_batch
    from protoclip_tpu_torch.eval import alpha_beta_sweep, best_operating_point
    from protoclip_tpu_torch.eval import default_alpha_beta_grid
    from protoclip_tpu_torch.memory import banks
    from protoclip_tpu_torch.models.clip import encode_image, encode_text
    from protoclip_tpu_torch.ops import kernels as K

    calls = {"image": 0, "text": 0}

    @torch.inference_mode()
    def encode_fn(images_u8):
        calls["image"] += 1
        x = normalize_batch(torch.from_numpy(images_u8).cuda(), torch.bfloat16)
        return encode_image(params, x, cfg)

    @torch.inference_mode()
    def encode_text_fn(tokens):
        calls["text"] += 1
        return encode_text(params, torch.from_numpy(tokens).cuda(), cfg)

    banks.tokenize = synthetic_tokenize  # the BPE vocab is not in the repository
    alphas, betas = default_alpha_beta_grid()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t1 = time.perf_counter()
    bank_v, values = banks.build_visual_memory_bank(
        encode_fn, ArrayLoader(*data["train"], IMAGE_BATCH), AUGMENT, progress=False
    )
    bank_t = banks.build_textual_memory_bank(
        encode_text_fn, data["classnames"], TEMPLATES, batch_size=TEXT_BATCH
    )
    val_f, val_l = banks.pre_load_features(encode_fn, ArrayLoader(*data["val"], IMAGE_BATCH),
                                           "val", progress=False)
    test_f, test_l = banks.pre_load_features(encode_fn, ArrayLoader(*data["test"], IMAGE_BATCH),
                                             "test", progress=False)
    model = from_arrays(bank_v, bank_t, {}, "fc", SHOTS)
    img_p, txt_p = model.prototypes()
    grid = alpha_beta_sweep(val_f, val_l, img_p, txt_p, alphas, betas)
    best = best_operating_point(grid, alphas, betas)
    acc = accuracy(model, test_f, test_l, 0.5, 5.0)
    probs = model.probs(test_f, 0.5, 5.0)
    extra = serving(calls) if serving is not None else {}
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t1
    counts = K.launch_counts()

    d = cfg.embed_dim
    require(bank_v.shape == (N_CLASS * SHOTS, d) and values.shape == (N_CLASS * SHOTS, N_CLASS),
            f"visual bank {bank_v.shape}, values {values.shape}")
    require(bank_t.shape == (N_CLASS, d), f"textual bank {bank_t.shape}")
    require(val_f.shape == (N_EVAL, d) and test_f.shape == (N_EVAL, d), "split features")
    for name, arr in (("bank_v", bank_v), ("bank_t", bank_t), ("val", val_f), ("test", test_f)):
        require(np.isfinite(arr).all(), f"{name} has non-finite values")
        require(np.allclose(np.linalg.norm(arr, axis=-1), 1.0, atol=1e-4), f"{name} rows not unit")
    require(tuple(probs.shape) == (N_EVAL, N_CLASS) and bool(torch.isfinite(probs).all()),
            "probabilities")
    require(float((probs.sum(-1) - 1).abs().max()) < 1e-4, "probability rows do not sum to 1")
    require(grid.shape == (len(alphas), len(betas)) and np.isfinite(grid).all(), "sweep grid")
    require(0.0 <= acc <= 1.0, f"accuracy {acc}")
    summary = {
        "backbone": cfg.name, "dtype": "bfloat16", "weights": "random, seed 0",
        "tokenizer": "synthetic: the BPE vocab is not in the repository",
        "n_class": N_CLASS, "shots": SHOTS, "augment_epoch": AUGMENT, "val": N_EVAL,
        "test": N_EVAL, "image_encode_calls": calls["image"], "text_encode_calls": calls["text"],
        "launches": counts, "best_alpha": best[0], "best_beta": best[1], "best_val_acc": best[2],
        "test_acc_alpha0.5_beta5": acc, "main_path_s": main_s, **extra,
    }
    return summary, counts


def card_features(torch, cfg, params, ref):
    """The card's features of the reference images and prompts, in fp32."""
    from protoclip_tpu_torch.data import normalize_batch
    from protoclip_tpu_torch.models.clip import encode_image, encode_text

    with torch.inference_mode():
        img = encode_image(params, normalize_batch(ref["images"].cuda(), torch.bfloat16), cfg)
        txt = encode_text(params, ref["tokens"].cuda(), cfg)
    return img.float().cpu(), txt.float().cpu()


def row_cosines(torch, a, b):
    return torch.nn.functional.cosine_similarity(a, b, dim=-1)


def phase_main(torch, np):
    from protoclip_tpu_torch.data import normalize_batch
    from protoclip_tpu_torch.models.clip import encode_image, encode_text, load_clip

    t0 = time.perf_counter()
    cfg, params = load_clip("ViT-B/16", dtype=torch.bfloat16, seed=SEED)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    data = make_data(np, cfg.image_resolution)
    summary, counts = run_zero_shot(torch, np, cfg, params, data)
    per_call = (cfg.vision_layers * summary["image_encode_calls"]
                + cfg.transformer_layers * summary["text_encode_calls"])
    require(counts["fused_transformer_block"] == per_call,
            f"K2 launched {counts['fused_transformer_block']} times, expected {per_call}")
    require(counts["layernorm_rows"] == 2 * per_call and counts["gemm_bias_epilogue"] == 4 * per_call
            and counts["attention_packed"] == per_call, f"kernel launches {counts}")
    require(counts["fused_transformer_block_int8"] == 0, f"K3 ran outside the int8 mode: {counts}")

    # the card's bf16 features against the plain path in fp32 on the CPU
    ref = {"images": torch.from_numpy(data["test"][0][:2]),
           "tokens": torch.from_numpy(synthetic_tokenize(["a photo of a class_1.",
                                                          "art of the class_7."]))}
    with torch.inference_mode():
        _, cpu_params = load_clip("ViT-B/16", dtype=torch.float32, device="cpu", seed=SEED)
        ref["cpu_images"] = encode_image(cpu_params, normalize_batch(ref["images"], torch.float32),
                                         cfg)
        ref["cpu_texts"] = encode_text(cpu_params, ref["tokens"], cfg)
    del cpu_params
    card_i, card_t = card_features(torch, cfg, params, ref)
    cos_i = row_cosines(torch, card_i, ref["cpu_images"])
    cos_t = row_cosines(torch, card_t, ref["cpu_texts"])
    require(float(cos_i.min()) >= 0.999 and float(cos_t.min()) >= 0.999,
            f"card vs CPU fp32 feature cosine: images {cos_i.tolist()}, texts {cos_t.tolist()}")
    emit({"phase": "main", **summary, "load_s": load_s,
          "cos_vs_cpu_fp32_images": cos_i.tolist(), "cos_vs_cpu_fp32_texts": cos_t.tolist()})
    return cfg, params, counts, data, ref


SERVING_BATCH = 8


def phase_main_int8(torch, np, data, ref):
    """The W8A8 serving mode through load_clip and the serving encode."""
    from protoclip_tpu_torch.io import make_encode_fn
    from protoclip_tpu_torch.models.clip import load_clip

    with int8_mode():
        t0 = time.perf_counter()
        cfg, params = load_clip("ViT-B/16", dtype=torch.bfloat16, seed=SEED)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        for tower, n in (("visual", cfg.vision_layers), ("text", cfg.transformer_layers)):
            qb = params[tower].get("blocks_q")
            require(qb is not None and len(qb) == n and qb[0]["wqkv"].dtype == torch.int8,
                    f"load_clip attached no int8 layers to the {tower} tower")
        encode = make_encode_fn(cfg)
        batch = torch.from_numpy(data["test"][0][:SERVING_BATCH])
        served = {}

        def serving(calls):
            calls["image"] += 1
            served["features"] = encode(params, batch.cuda())
            return {"serving_batch": SERVING_BATCH}

        summary, counts = run_zero_shot(torch, np, cfg, params, data, serving)
        card_i, card_t = card_features(torch, cfg, params, ref)

    k3 = (cfg.vision_layers * summary["image_encode_calls"]
          + cfg.transformer_layers * summary["text_encode_calls"])
    require(counts["fused_transformer_block_int8"] == k3,
            f"K3 launched {counts['fused_transformer_block_int8']} times, expected {k3}")
    require(counts["fused_transformer_block"] == 0 and counts["layernorm_rows"] == 0
            and counts["gemm_bias_epilogue"] == 0, f"K2 ran in the int8 mode: {counts}")
    require(counts["layernorm_quant_rows"] == 2 * k3 and counts["quant_rows"] == 2 * k3
            and counts["gemm_int8_epilogue"] == 4 * k3 and counts["attention_packed"] == k3,
            f"kernel launches {counts}")
    feats = served["features"].cpu()
    require(tuple(feats.shape) == (SERVING_BATCH, cfg.embed_dim) and feats.dtype == torch.float32
            and bool(torch.isfinite(feats).all()), f"serving features {tuple(feats.shape)}")
    require(float((feats.norm(dim=-1) - 1).abs().max()) < 1e-4, "serving rows not unit")
    cos_i = row_cosines(torch, card_i, ref["cpu_images"])
    cos_t = row_cosines(torch, card_t, ref["cpu_texts"])
    cos_s = row_cosines(torch, feats[:2], ref["cpu_images"])
    require(min(float(cos_i.min()), float(cos_t.min()), float(cos_s.min())) >= 0.995,
            f"int8 card vs CPU fp32 cosine: images {cos_i.tolist()}, texts {cos_t.tolist()}, "
            f"serving {cos_s.tolist()}")
    emit({"phase": "main_int8", **summary, "mode": "W8A8 ($PROTOCLIP_INT8)", "load_s": load_s,
          "cos_vs_cpu_fp32_images": cos_i.tolist(), "cos_vs_cpu_fp32_texts": cos_t.tolist(),
          "cos_vs_cpu_fp32_serving": cos_s.tolist()})
    return cfg, params, counts


# -- 6. the runner: RN50 through the user's entry points ------------------------------

RUNNER_BACKBONE = "RN50"
RUNNER_BATCH = 64
RN_DAMP = 0.25


def write_caltech_tree(np, root):
    """A synthetic caltech101 tree (the layout of tests/test_e2e.py): N_CLASS
    folders of class-coloured JPEGs, SHOTS train and N_EVAL / N_CLASS val and
    test images a class, and the CoOp split JSON."""
    from PIL import Image

    np_rng = np.random.default_rng(SEED)
    colours = np_rng.integers(0, 200, (N_CLASS, 3))
    img_dir = os.path.join(root, "caltech-101", "101_ObjectCategories")
    rows = {"train": [], "val": [], "test": []}
    per_split = (("train", SHOTS), ("val", N_EVAL // N_CLASS), ("test", N_EVAL // N_CLASS))
    for c in range(N_CLASS):
        cname = f"class_{c}"
        os.makedirs(os.path.join(img_dir, cname))
        for split, count in per_split:
            for i in range(count):
                rel = f"{cname}/{split}_{i}.jpg"
                noise = np_rng.integers(0, 56, (240, 300, 3))
                Image.fromarray((colours[c] + noise).astype(np.uint8)).save(
                    os.path.join(img_dir, rel), quality=95)
                rows[split].append([rel, c, cname])
    with open(os.path.join(root, "caltech-101", "split_zhou_Caltech101.json"), "w") as fh:
        json.dump(rows, fh)


def phase_runner(torch, np):
    """Test-only Proto-CLIP on RN50 at full width (224 px, layers 3-4-6-3,
    width 64, embed 1024; random weights, seed 0; bf16) through the port's
    own entry points: ``prepare_experiment`` encodes a synthetic caltech101
    tree on the card and writes the caches in the reference's tree, a
    ``_v/_t/_a`` triple is saved, and ``run(only_test=True)`` scores it from
    the caches alone.  The launch counts are set to 0 just before each of
    the two runs and read just after it."""
    import tempfile

    from protoclip_tpu_torch.core import Config, accuracy, from_arrays
    from protoclip_tpu_torch.data import EvalTransform, load_image, normalize_batch
    from protoclip_tpu_torch.io import (checkpoint_paths, load_checkpoint_triple,
                                        save_checkpoint_triple)
    from protoclip_tpu_torch.memory import banks
    from protoclip_tpu_torch.models import (adapter_from_torch_state, adapter_to_torch_state,
                                            cast_params, encode_image, encode_text, init_adapter,
                                            load_clip)
    from protoclip_tpu_torch.models.clip import to_device
    from protoclip_tpu_torch.ops import kernels as K
    from protoclip_tpu_torch.train import runner

    calls = {"image": 0, "text": 0}

    def counted(fn, kind):
        def wrapper(*args, **kwargs):
            calls[kind] += 1
            return fn(*args, **kwargs)
        return wrapper

    banks.tokenize = synthetic_tokenize  # the BPE vocab is not in the repository
    runner.encode_image = counted(encode_image, "image")
    runner.encode_text = counted(encode_text, "text")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_runner_") as tmp:
        write_caltech_tree(np, os.path.join(tmp, "DATA"))
        cfg = Config(dataset="caltech101", root_path=os.path.join(tmp, "DATA"), shots=SHOTS,
                     backbone=RUNNER_BACKBONE, augment_epoch=AUGMENT, alpha=0.5, beta=5.0,
                     adapter="fc", batch_size=RUNNER_BATCH, only_test=True,
                     cache_root=os.path.join(tmp, "caches"),
                     logs_dir_path=os.path.join(tmp, "logs"), compute_dtype="bfloat16")

        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        setup = runner.prepare_experiment(cfg, progress=False)
        torch.cuda.synchronize()
        prepare_s = time.perf_counter() - t0
        prepare_counts = K.launch_counts()
        prepare_calls = dict(calls)

        stems = [*setup.cache.visual_bank_stems(AUGMENT), setup.cache.text_bank_stem(),
                 *setup.cache.split_stems("val"), *setup.cache.split_stems("test")]
        missing = [s for s in stems if not os.path.exists(os.path.join(setup.cache.root,
                                                                       s + ".npz"))]
        require(not missing, f"cache files missing at the reference stems: {missing}")
        paths = checkpoint_paths(cfg.cache_dir, cfg.backbone, cfg.shots, cfg.alpha, cfg.beta,
                                 cfg.lr, cfg.augment_epoch, cfg.train_epoch)
        adapter = init_adapter(torch.Generator().manual_seed(SEED), setup.bank_t.shape[1], "fc")
        save_checkpoint_triple(*paths, setup.bank_v, setup.bank_t,
                               adapter_to_torch_state(adapter, "fc"))

        calls.update(image=0, text=0)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        result = runner.run(cfg, progress=False)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        run_counts = K.launch_counts()
        run_calls = dict(calls)

        bank_v, bank_t, state = load_checkpoint_triple(*paths)
        model = from_arrays(bank_v, bank_t, adapter_from_torch_state(state, "fc"), "fc", SHOTS)
        acc = accuracy(model, setup.test_feats, setup.test_labels, cfg.alpha, cfg.beta)
        clip_cfg = setup.clip_cfg
        images = np.stack([EvalTransform(clip_cfg.image_resolution)(load_image(d.impath))
                           for d in setup.dataset.test[:2]])
    runner.encode_image, runner.encode_text = encode_image, encode_text

    k2 = clip_cfg.transformer_layers * prepare_calls["text"]
    require(prepare_calls["image"] > 0 and prepare_calls["text"] > 0,
            f"prepare_experiment encoded {prepare_calls}")
    require(prepare_counts["fused_transformer_block"] == k2
            and prepare_counts["layernorm_rows"] == 2 * k2
            and prepare_counts["gemm_bias_epilogue"] == 4 * k2
            and prepare_counts["attention_packed"] == k2
            and prepare_counts["fused_transformer_block_int8"] == 0,
            f"prepare_experiment launches {prepare_counts}, expected K2 x {k2}")
    require(run_calls == {"image": 0, "text": 0} and not any(run_counts.values()),
            f"run(only_test) encoded {run_calls} with launches {run_counts}: not from the cache")
    d = clip_cfg.embed_dim
    require(setup.bank_v.shape == (N_CLASS * SHOTS, d) and setup.bank_t.shape == (N_CLASS, d)
            and setup.test_feats.shape == (N_EVAL, d), "runner features")
    require(abs(acc - result.test_acc_fixed) <= 1e-6,
            f"test_acc_fixed {result.test_acc_fixed} but the cached features and the triple "
            f"give {acc}")

    # RN50 on the card against the plain path in fp32 on the CPU.  This
    # random init (He-normal convs, identity BN, as the JAX package draws
    # them) doubles the activations' variance at every residual add, so the
    # attention pool's softmax is close to an argmax, which bf16 rounding
    # can move.  The image tower is held in fp32 as loaded, and in bf16 with
    # its residual branches damped (every bn3 scale x RN_DAMP), where the
    # scores stay small; the runner's own bf16 cosines are reported.
    tokens = torch.from_numpy(synthetic_tokenize(["a photo of a class_1.", "a photo of a class_7."]))
    batch = torch.from_numpy(images)
    cpu_i, card_i = {}, {}
    with torch.inference_mode():
        _, cpu_params = load_clip(RUNNER_BACKBONE, dtype=torch.float32, device="cpu", seed=SEED)
        cpu_t = encode_text(cpu_params, tokens, clip_cfg)
        for name, visual, dtype in (
            ("fp32", cpu_params["visual"], torch.float32),
            ("bf16_damped", damped_resnet(cpu_params["visual"]), torch.bfloat16),
        ):
            tower = {"visual": visual}
            cpu_i[name] = encode_image(tower, normalize_batch(batch, torch.float32), clip_cfg)
            card = to_device(cast_params(tower, dtype), torch.device("cuda"))
            card_i[name] = encode_image(card, normalize_batch(batch.cuda(), dtype),
                                        clip_cfg).float().cpu()
        cpu_i["bf16"] = cpu_i["fp32"]
    del cpu_params, card
    card_i["bf16"], card_t = card_features(torch, clip_cfg, setup.clip_params,
                                           {"images": batch, "tokens": tokens})
    cos = {k: row_cosines(torch, card_i[k], cpu_i[k]).tolist() for k in card_i}
    cos_t = row_cosines(torch, card_t, cpu_t)
    rel32 = float((card_i["fp32"] - cpu_i["fp32"]).abs().max() / cpu_i["fp32"].abs().max())
    require(min(cos["fp32"]) >= 0.99999 and rel32 <= 1e-4 and min(cos["bf16_damped"]) >= 0.999
            and float(cos_t.min()) >= 0.999,
            f"RN50 card vs CPU fp32: image cosines {cos} (fp32 rel err {rel32}), "
            f"text cosines {cos_t.tolist()}")
    emit({"phase": "runner", "backbone": clip_cfg.name, "dtype": "bfloat16",
          "weights": "random, seed 0", "decode": "PIL",
          "tokenizer": "synthetic: the BPE vocab is not in the repository",
          "dataset": "synthetic caltech101 tree", "n_class": N_CLASS, "shots": SHOTS,
          "augment_epoch": AUGMENT, "val": N_EVAL, "test": N_EVAL, "batch_size": RUNNER_BATCH,
          "prepare_s": prepare_s, "run_only_test_s": run_s, "wall_s": prepare_s + run_s,
          "prepare_encode_calls": prepare_calls, "run_encode_calls": run_calls,
          "prepare_launches": prepare_counts, "run_launches": run_counts,
          "zero_shot": result.zero_shot, "test_acc_fixed": result.test_acc_fixed,
          "test_acc_fixed_from_cache_and_triple": acc,
          "test_acc_searched": result.test_acc_searched,
          "searched_alpha": result.searched_alpha, "searched_beta": result.searched_beta,
          "cos_vs_cpu_fp32_images": cos["bf16"], "cos_vs_cpu_fp32_texts": cos_t.tolist(),
          "image_tower_fp32_cos_vs_cpu": cos["fp32"], "image_tower_fp32_rel_err": rel32,
          "image_tower_bf16_damped_cos_vs_cpu": cos["bf16_damped"], "damp": RN_DAMP})
    return clip_cfg, setup.clip_params, prepare_counts


def damped_resnet(visual):
    """A ResNet tower whose residual branches are scaled by RN_DAMP (each
    Bottleneck's last folded BN), so the activations stay O(1)."""
    out = dict(visual)
    for i in range(1, 5):
        out[f"layer{i}"] = [{**b, "bn3": {"scale": b["bn3"]["scale"] * RN_DAMP,
                                          "bias": b["bn3"]["bias"]}}
                            for b in visual[f"layer{i}"]]
    return out


# -- 7. times ------------------------------------------------------------------------

TIME_RUNS = 12


def median_ms(torch, fn, runs=TIME_RUNS, warmup=2):
    """Median of per-run CUDA-event times after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


SPIN_CYCLES = 20_000_000  # ~10 ms of a spinning kernel at the H100's clock


def device_ms(torch, fn, runs=TIME_RUNS):
    """Median CUDA-event time of one call of ``fn`` enqueued behind a
    spinning kernel (``torch.cuda._sleep``): the host has issued every launch
    of the call before the start event runs, so the host's time to reach the
    launches, which :func:`median_ms` includes (most of it for a kernel
    shorter than its Python wrapper), is hidden and the time is the
    device's."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bound_ms(n_bytes, ops, dtype="bfloat16"):
    """(least ms, what bounds it, bytes ms, operations ms).  ``ops`` is a
    count in ``dtype`` or a {dtype: count} map, each at its peak rate."""
    ops = ops if isinstance(ops, dict) else {dtype: ops}
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = sum(n / PEAK_FLOPS[dt] for dt, n in ops.items()) * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations"), \
        by_bytes, by_ops


def ulp_steps(out, ref):
    """|out - ref| in units in the last place of their dtype (bf16 or fp32),
    counted across zero: the distance of their bit patterns in order."""
    import torch

    int_t, width = (torch.int16, 16) if out.dtype == torch.bfloat16 else (torch.int32, 32)

    def ordered(t):
        bits = t.contiguous().view(int_t).long()
        return torch.where(bits >= 0, bits, -(bits + (1 << (width - 1))))

    return (ordered(out) - ordered(ref)).abs()


def attention_flops(b, l, d, causal):
    pairs = l * (l + 1) // 2 if causal else l * l  # keys a query attends
    return 4 * b * pairs * d


def _max_abs_err(out, ref):
    outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
    return max(float((o.double() - r.double()).abs().max()) for o, r in zip(outs, refs))


def phase_times(torch, np, params, qparams):
    """Each kernel at the main path's encode batches: the ViT-B/16 image
    block at B=256 and the text block at B=1024 (layer 0's weights, and
    layer 0's int8 layer for K3)."""
    import torch.nn.functional as F

    from protoclip_tpu_torch.ops import kernels as K

    bf16 = torch.bfloat16
    shapes = {"image": ("visual", 256, 197, 12, False), "text": ("text", 1024, 77, 8, True)}
    results = {}
    for tag, (tower, b, l, h, causal) in shapes.items():
        blk, qb = params[tower]["blocks"][0], qparams[tower]["blocks_q"][0]
        d = blk["attn"]["wo"].shape[0]
        dh = d // h
        g = torch.Generator(device="cuda").manual_seed(SEED)
        x = torch.randn(b, l, d, device="cuda", generator=g).to(bf16)
        p = K._block_args(blk, bf16)
        ln1 = K.layernorm_rows_plain(x, p["ln1s"], p["ln1b"])
        qkv = K.gemm_bias_epilogue_plain(ln1, p["wqkv"], p["bqkv"], "bias")
        sl = (qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:])
        attn = K.fused_attention_packed_plain(*sl, h, causal)
        hid = K.gemm_bias_epilogue_plain(ln1, p["wfc"], p["bfc"], "bias_gelu")
        m = b * l
        r = {}

        def entry(name, kernel, plain, library, n_bytes, ops, dtype="bfloat16"):
            out, ref = kernel(), plain()
            torch.cuda.synchronize()
            bnd, by, by_bytes, by_ops = bound_ms(n_bytes, ops, dtype)
            lib_ms, lib_note = None, None
            if library is not None:
                try:
                    lib_ms = median_ms(torch, library)
                except RuntimeError as exc:  # the library call does not take this shape
                    lib_note = str(exc).splitlines()[0][:200]
            r[name] = {
                "ms": median_ms(torch, kernel), "device_ms": device_ms(torch, kernel),
                "plain_ms": median_ms(torch, plain),
                "library_ms": lib_ms, "bound_ms": bnd, "bound_by": by,
                "bytes_ms": by_bytes, "ops_ms": by_ops, "max_abs_err": _max_abs_err(out, ref),
            }
            if lib_note:
                r[name]["library_error"] = lib_note
            del out, ref

        entry("layernorm_rows",
              lambda: K.layernorm_rows(x, p["ln1s"], p["ln1b"]),
              lambda: K.layernorm_rows_plain(x, p["ln1s"], p["ln1b"]),
              lambda: F.layer_norm(x, (d,), p["ln1s"].to(x.dtype), p["ln1b"].to(x.dtype)),
              2 * m * d * 2 + 2 * d * 4, 8 * m * d)
        gemms = {  # name: (a, w, bias, epilogue, residual)
            "qkv": (ln1, p["wqkv"], p["bqkv"], "bias", None),
            "out_proj": (attn, p["wo"], p["bo"], "bias_residual", x),
            "fc": (ln1, p["wfc"], p["bfc"], "bias_gelu", None),
            "proj": (hid, p["wproj"], p["bproj"], "bias_residual", x),
        }
        for gname, (a, w, bias, epi, res) in gemms.items():
            kk, nn = w.shape
            a2, r2 = a.reshape(m, kk), None if res is None else res.reshape(m, nn)

            def library(a2=a2, w=w, bias=bias, epi=epi, r2=r2):
                y = torch.addmm(bias, a2, w)
                if epi == "bias_gelu":
                    return y * torch.sigmoid(1.702 * y)
                return y if r2 is None else r2 + y

            entry(f"gemm_bias_epilogue.{gname}",
                  lambda a=a, w=w, bias=bias, epi=epi, res=res: K.gemm_bias_epilogue(a, w, bias, epi, res),
                  lambda a=a, w=w, bias=bias, epi=epi, res=res: K.gemm_bias_epilogue_plain(a, w, bias, epi, res),
                  library,
                  (m * kk + kk * nn + nn + m * nn * (2 if res is not None else 1)) * 2,
                  2 * m * kk * nn)

        def heads(t):
            return t.reshape(b, l, h, dh).transpose(1, 2)

        attn_bytes, attn_flops = 4 * b * l * d * 2, attention_flops(b, l, d, causal)
        entry("attention_packed",
              lambda: K.attention_packed(*sl, h, causal),
              lambda: K.fused_attention_packed_plain(*sl, h, causal),
              lambda: F.scaled_dot_product_attention(*map(heads, sl), is_causal=causal),
              attn_bytes, attn_flops)
        q, k, v = (t.contiguous() for t in sl)
        entry("fused_attention_packed",
              lambda: K.fused_attention_packed(q, k, v, h, causal),
              lambda: K.fused_attention_packed_plain(q, k, v, h, causal),
              lambda: F.scaled_dot_product_attention(*map(heads, (q, k, v)), is_causal=causal),
              attn_bytes, attn_flops)
        qh, kh, vh = (heads(t).contiguous() for t in sl)
        entry("fused_attention",
              lambda: K.fused_attention(qh, kh, vh, causal),
              lambda: K.fused_attention_plain(qh, kh, vh, causal),
              lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal),
              attn_bytes, attn_flops)
        entry("fused_transformer_block",
              lambda: K.fused_transformer_block(x, blk, h, causal),
              lambda: K.fused_transformer_block_plain(x, blk, h, causal),
              None,
              (2 * m * d + 12 * d * d + 9 * d) * 2 + 4 * d * 4,
              24 * m * d * d + attn_flops)
        del ln1, qkv, hid, q, k, v, qh, kh, vh
        torch.cuda.empty_cache()

        # K3: its pieces at the shapes its chain gives them, and the block
        h_q = K.layernorm_quant_rows_plain(x, qb["ln1s"], qb["ln1b"])
        a_q = K.quant_rows_plain(attn)
        hid32 = K.gemm_int8_epilogue_plain(*h_q, qb["wfc"], qb["sfc"], qb["bfc"],
                                           "dequant_bias_gelu", bf16)
        hid_q = K.quant_rows_plain(hid32)
        entry("layernorm_quant_rows",
              lambda: K.layernorm_quant_rows(x, qb["ln1s"], qb["ln1b"]),
              lambda: K.layernorm_quant_rows_plain(x, qb["ln1s"], qb["ln1b"]),
              None, m * d * 2 + m * d + m * 4 + 2 * d * 4, 10 * m * d, "float32")
        entry("quant_rows.attn", lambda: K.quant_rows(attn), lambda: K.quant_rows_plain(attn),
              None, m * d * 2 + m * d + m * 4, 3 * m * d, "float32")
        entry("quant_rows.hidden", lambda: K.quant_rows(hid32), lambda: K.quant_rows_plain(hid32),
              None, m * 4 * d * 4 + m * 4 * d + m * 4, 3 * m * 4 * d, "float32")
        int8_gemms = {  # name: (quantized input, weight, epilogue, residual)
            "qkv": (h_q, "qkv", "dequant_bias", None),
            "out_proj": (a_q, "o", "dequant_bias_residual", x),
            "fc": (h_q, "fc", "dequant_bias_gelu", None),
            "proj": (hid_q, "proj", "dequant_bias_residual", x),
        }
        for gname, ((aq, as_), wname, epi, res) in int8_gemms.items():
            w_q, w_s, bias = qb["w" + wname], qb["s" + wname], qb["b" + wname]
            nn, kk = w_q.shape
            a2, rs2 = aq.reshape(m, kk), as_.reshape(m, 1)
            r2 = None if res is None else res.reshape(m, nn)
            args = (aq, as_, w_q, w_s, bias, epi, bf16)

            def library(a2=a2, rs2=rs2, w_q=w_q, w_s=w_s, bias=bias, epi=epi, r2=r2):
                y = torch._int_mm(a2, w_q.t()).float() * rs2 * w_s + bias
                if epi == "dequant_bias_gelu":
                    return y * torch.sigmoid(1.702 * y)
                y = y.to(bf16)
                return y if r2 is None else r2 + y

            out_bytes = m * nn * (4 if epi == "dequant_bias_gelu" else 2)
            entry(f"gemm_int8_epilogue.{gname}",
                  lambda args=args, res=res: K.gemm_int8_epilogue(*args, residual=res),
                  lambda args=args, res=res: K.gemm_int8_epilogue_plain(*args, residual=res),
                  library,
                  m * kk + nn * kk + 4 * (m + 2 * nn) + out_bytes + (0 if res is None else m * nn * 2),
                  {"int8": 2 * m * kk * nn})
        del h_q, a_q, hid32, hid_q
        torch.cuda.empty_cache()
        entry("fused_transformer_block_int8",
              lambda: K.fused_transformer_block_int8(x, qb, h, causal),
              lambda: K.fused_transformer_block_int8_plain(x, qb, h, causal),
              None,
              2 * m * d * 2 + 12 * d * d + (9 * d + 9 * d + 4 * d) * 4,
              {"int8": 24 * m * d * d, "bfloat16": attn_flops})
        results[tag] = {"batch": b, "L": l, "D": d, "heads": h, "causal": causal, "kernels": r}
        del x, sl, attn
        torch.cuda.empty_cache()
    for tag, res in results.items():
        emit({"phase": "times", "shape": tag, **res})
    return results


def phase_encode_times(torch, cfg, params, qparams, rn_cfg, rn_params):
    """Whole-tower encode time at the timing batches, through the kernels:
    bf16 (K2) and the W8A8 serving mode (K3); and RN50's image tower in bf16
    (cuDNN convolutions, no kernel of the port)."""
    from protoclip_tpu_torch.models.clip import encode_image, encode_text

    g = torch.Generator(device="cuda").manual_seed(SEED)
    px = cfg.image_resolution
    images = torch.randn(256, px, px, 3, device="cuda", generator=g).to(torch.bfloat16)
    tokens = torch.randint(1, SOT_ID, (1024, cfg.context_length), device="cuda", generator=g)
    tokens[:, 0] = SOT_ID
    tokens[torch.arange(1024), torch.randint(2, cfg.context_length, (1024,), device="cuda",
                                              generator=g)] = EOT_ID
    out = {"phase": "encode_times", "image_batch": 256, "text_batch": 1024}
    for mode, p, ctx in (("bf16", params, contextlib.nullcontext), ("int8", qparams, int8_mode)):
        with ctx(), torch.inference_mode():
            img_ms = median_ms(torch, lambda: encode_image(p, images, cfg), runs=10)
            txt_ms = median_ms(torch, lambda: encode_text(p, tokens, cfg), runs=10)
        out.update({f"{mode}_image_encode_ms": img_ms, f"{mode}_images_per_s": 256 / img_ms * 1e3,
                    f"{mode}_text_encode_ms": txt_ms, f"{mode}_prompts_per_s": 1024 / txt_ms * 1e3})
    rn_px = rn_cfg.image_resolution
    rn_images = torch.randn(256, rn_px, rn_px, 3, device="cuda", generator=g).to(torch.bfloat16)
    with torch.inference_mode():
        rn_ms = median_ms(torch, lambda: encode_image(rn_params, rn_images, rn_cfg), runs=10)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            encode_image(rn_params, rn_images, rn_cfg)
            torch.cuda.synchronize()
    out.update({"rn50_bf16_image_encode_ms": rn_ms, "rn50_bf16_images_per_s": 256 / rn_ms * 1e3,
                **device_ms_by_kind(prof)})
    emit(out)


def device_ms_by_kind(prof):
    """One profiled encode's device time by kind of kernel (convolutions and
    products, pools, elementwise passes) and its ten longest kernels."""
    kinds, kernels = {}, []
    for ev in prof.key_averages():
        ms = ev.self_device_time_total / 1e3
        if not ms:
            continue
        name = ev.key.lower()
        if any(t in name for t in ("conv", "xmma", "gemm", "cudnn", "cutlass", "implicit")):
            kind = "conv_and_gemm"
        elif "pool" in name:
            kind = "pool"
        elif any(t in name for t in ("elementwise", "vectorized", "unrolled", "reduce")):
            kind = "elementwise"
        else:
            kind = "other"
        kinds[kind] = kinds.get(kind, 0.0) + ms
        kernels.append((ms, ev.count, ev.key[:90]))
    kernels.sort(reverse=True)
    return {"rn50_profiled_device_ms_by_kind": kinds or None,
            "rn50_profiled_top_kernels": [{"ms": ms, "calls": n, "name": k}
                                          for ms, n, k in kernels[:10]]}
    return out


# -- 8. the block-variant bench (S1) -------------------------------------------------------

VARIANTS = (
    "v0 v1 v2 v3 v4 v5 v6 v6g8 v7 v9 v2g8 v2g32 v10 "
    "int8 int8g8 int8g32 int8h int8gb int8noattn int8static int8recip int8cast int8lnb int8s "
    "int8sg8 micro:mlp_xla micro:mlp_pallas micro:int8mlp micro:int8mlp_nogelu "
    "micro:int8mlp_fp32gelu micro:int8qkv micro:attn_pallas micro:attn_nosm micro:attn_noqkv"
).split()
VARIANTS_VITL = ("v0", "v2", "int8", "int8s")
VARIANT_CHECK_BATCH = 16
# a variant's 12-layer stack on the kernels against the plain versions on
# the card at B=16: (max|diff| / max|plain|, cosine)
STACK_BARS = {"bf16": (2e-2, 0.9999), "int8": (5e-2, 0.999)}
# one block of a site against its plain version at the bench's full batch:
# the check phase's bars for K2's block (bf16) and K3's (int8)
SITE_BARS = {"bf16": BARS["bfloat16"], "int8": INT8_BLOCK_BARS["bfloat16"]}


def site_work(site, b, lp, length, d, attention="bf16"):
    """(bytes, {dtype: operations}) of one block of an S1 site: each input
    read once, each output written once; rows are the LP padded rows, a
    query attends ``length`` keys (all LP for ``attention="all"``), and
    ``attention`` says which dot type the core uses (bf16, int8, all,
    none)."""
    m = b * lp
    keys = lp if attention == "all" else length
    attn = 4 * b * lp * keys * d if attention != "none" else 0
    attn_dt = "int8" if attention == "int8" else "bfloat16"
    if site == "bench_block_bf16":
        return (2 * m * d + 12 * d * d + 9 * d) * 2 + 4 * d * 4, {"bfloat16": 24 * m * d * d + attn}
    if site == "bench_block_int8":
        ops = {"int8": 24 * m * d * d}
        ops[attn_dt] = ops.get(attn_dt, 0) + attn
        return 2 * m * d * 2 + 12 * d * d + 22 * d * 4, ops
    if site == "bench_mlp_bf16":
        return (2 * m * d + 8 * d * d + 5 * d) * 2, {"bfloat16": 16 * m * d * d}
    if site == "bench_mlp_int8":
        return 2 * m * d * 2 + 8 * d * d + 12 * d * 4, {"int8": 16 * m * d * d}
    if site == "bench_qkv_int8":
        return 2 * m * d * 2 + 4 * d * d + 12 * d * 4, {"int8": 8 * m * d * d}
    if site == "bench_attn_bf16":
        return (2 * m * d + 4 * d * d + 4 * d) * 2 + 2 * d * 4, {"bfloat16": 8 * m * d * d + attn}
    raise ValueError(site)


def variant_site(prep):
    """(S1 site, attention type) of a prepared bench variant."""
    spec = prep.spec
    if spec["kind"] == "stack":
        return "bench_block_bf16", "bf16"
    if spec["kind"] == "int8":
        if spec["skip_attn"] and not spec["quant_scores"]:
            return "bench_block_int8", "none"
        return "bench_block_int8", ("int8" if spec["quant_scores"] else "bf16")
    which = spec["which"].split("@")[0]
    if which in ("mlp_xla", "mlp_pallas"):
        return "bench_mlp_bf16", "none"
    if which.startswith("int8mlp"):
        return "bench_mlp_int8", "none"
    if which == "int8qkv":
        return "bench_qkv_int8", "none"
    return "bench_attn_bf16", {"attn_pallas": "bf16", "attn_nosm": "all"}.get(which, "none")


def int8s_qkv(prep):
    """Layer 0's QKV of an int8s stack, as its block computes it: the input
    of its first attention_int8 launch."""
    from protoclip_tpu_torch.ops import kernels as K

    wqkv, sqkv, bqkv, _, _, _, ln1s, ln1b = prep.layers[0][:8]
    return K.gemm_int8_epilogue(*K.layernorm_quant_rows(prep.x, ln1s, ln1b), wqkv, sqkv, bqkv,
                                "dequant_bias", prep.x.dtype)


def hold_chain(torch, prep, geom, numerics):
    """A variant's chain against its plain versions on the card: the
    12-layer stack at B=16 (stack bars), layer 0's block at the full batch
    (site bars), and, for int8s, its attention core on layer 0's QKV at the
    full batch and the variant's group (bit-exact, or the moved outputs
    counted within :func:`int8_attention_agreement`'s bar)."""
    from protoclip_tpu_torch.ops import block_variants as bv
    from protoclip_tpu_torch.ops import kernels as K
    from protoclip_tpu_torch.scripts import bench_block_variants as bench

    with torch.inference_mode():
        out = bench.stack_output(prep, bv.KERNEL_OPS, VARIANT_CHECK_BATCH)
        ref = bench.stack_output(prep, bv.PLAIN_OPS, VARIANT_CHECK_BATCH)
        held = {"stack_b16": bars_agreement(out, ref, STACK_BARS[numerics])}
        del out, ref
        layer0 = prep.layers[0]
        held["block_full_batch"] = bars_agreement(prep.block(prep.x, layer0, bv.KERNEL_OPS),
                                                  prep.block(prep.x, layer0, bv.PLAIN_OPS),
                                                  SITE_BARS[numerics])
        if prep.spec.get("quant_scores"):
            qkv = int8s_qkv(prep)
            sl = (qkv[..., :geom.width], qkv[..., geom.width:2 * geom.width],
                  qkv[..., 2 * geom.width:])
            held["attention_int8_full_batch"] = agreement(
                K.attention_int8(*sl, geom.heads, geom.length, prep.g),
                K.attention_int8_plain(*sl, geom.heads, geom.length, prep.g),
                int8_attention_rule(sl[2]))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return held


def phase_variants(torch, np):
    """The port's block-variant bench on the card: every variant of the
    chip list at the full ViT-B/16 geometry, and four at ViT-L/14, each
    timed as the bench times it (minimum of 8 after a warm-up; the median
    too), with its launches.  Each distinct chain is held against its plain
    versions (:func:`hold_chain`) once; a variant that only reschedules its
    twin must give the twin's checksum bit for bit.  The launches of the
    timed runs, and the site blocks they ran, are the "variants" path; the
    comparisons' launches are not counted."""
    from protoclip_tpu_torch.ops import block_variants as bv
    from protoclip_tpu_torch.ops import kernels as K
    from protoclip_tpu_torch.scripts import bench_block_variants as bench

    device = torch.device("cuda")
    counts = dict.fromkeys([*K.LAUNCHES, *bv.SITE_CALLS], 0)
    chains = {}  # (geometry, twin): (checksum, what hold_chain found)
    lines = []
    t0 = time.perf_counter()
    for tag, env, names in (("vit_b16", {}, VARIANTS), ("vit_l14", {"BENCH_GEOM": "vitl"},
                                                         VARIANTS_VITL)):
        geom = bv.geometry(env)
        for prep in bench.iter_prepared(names, geom, device):
            K.reset_launch_counts()
            bv.reset_site_calls()
            res = bench.time_stack(prep)
            run = {**K.launch_counts(), **bv.site_calls()}
            for k, n in run.items():
                counts[k] += n
            per_stack = {k: n // (bench.RUNS + 1) for k, n in run.items() if n}
            numerics = "int8" if "int8" in prep.name else "bf16"
            twin = bench.twin(prep.spec, geom)
            if (tag, twin) not in chains:
                chains[tag, twin] = (res["checksum"], hold_chain(torch, prep, geom, numerics))
            twin_checksum, held = chains[tag, twin]
            site, attention = variant_site(prep)
            n_bytes, ops = site_work(site, geom.batch, geom.padded, geom.length, geom.width,
                                     attention)
            bnd, by, _, _ = bound_ms(n_bytes * geom.layers,
                                     {dt: n * geom.layers for dt, n in ops.items()})
            stack = held["stack_b16"]
            line = {
                "phase": "variants", "variant": prep.name, "geometry": tag,
                "batch": geom.batch, "padded_rows": geom.padded, "g": prep.g,
                "twin": twin, "site": site,
                "ms_min": res["ms_min"], "ms_median": res["ms_median"],
                "checksum": res["checksum"], "first_call_s": res["compile_s"],
                "bound_ms": bnd, "bound_by": by, "launches_per_stack": per_stack,
                "check_batch": VARIANT_CHECK_BATCH, "numerics": numerics, "rel": stack["rel"],
                "cos": stack["cos"], "max_abs_err": stack["max_abs_err"], "held": held,
                "ok": bool(all(h["ok"] for h in held.values()) and np.isfinite(res["checksum"])
                           and res["checksum"] == twin_checksum),
                "line": bench.result_line(prep, res),
            }
            emit(line)
            lines.append(line)
            del prep
            torch.cuda.empty_cache()
    bad = [ln["variant"] + "@" + ln["geometry"] for ln in lines if not ln["ok"]]
    require(not bad, f"variants off their bars: {bad}")
    emit({"phase": "variants", "runs": len(lines), "chains_held": len(chains), "all_ok": True,
          "seconds": time.perf_counter() - t0})
    return lines, counts


def phase_variant_times(torch, np):
    """Each mode and kernel of the bench, and one block of each S1 site,
    at the bench's ViT-B/16 geometry (B=512, LP=200, D=768, H=12; layer 0
    of the bench's weights): kernel, plain version, a PyTorch library call
    where one computes the same function, and the bound.  Each kernel is
    held against its plain version on these inputs by the check phase's
    rule for it (:func:`agreement`)."""
    import torch.nn.functional as F

    from protoclip_tpu_torch.ops import block_variants as bv
    from protoclip_tpu_torch.ops import kernels as K
    from protoclip_tpu_torch.scripts import bench_block_variants as bench

    geom = bv.geometry({})
    b, lp, length, d, h = geom.batch, geom.padded, geom.length, geom.width, geom.heads
    m, dh = b * lp, d // h
    bf16 = torch.bfloat16
    dev = torch.device("cuda")
    x, w = bv.main_draws(geom)
    x = x.to(dev)
    layer = tuple(t[0].to(dev) for t in w)
    (wqkv, bqkv, wo, bo, ln1s, ln1b, ln2s, ln2b, wfc, bfc, wproj, bproj) = layer
    q8 = tuple(t.to(dev) for t in bench._int8_host_layers(geom, True)[0])
    r = {}

    def entry(name, rule, kernel, plain, library, n_bytes, ops, dtype="bfloat16"):
        with torch.inference_mode():
            out, ref = kernel(), plain()
            torch.cuda.synchronize()
            held = agreement(out, ref, rule)
            bnd, by, by_bytes, by_ops = bound_ms(n_bytes, ops, dtype)
            r[name] = {
                "ms": median_ms(torch, kernel), "device_ms": device_ms(torch, kernel),
                "plain_ms": median_ms(torch, plain),
                "library_ms": None if library is None else median_ms(torch, library),
                "bound_ms": bnd, "bound_by": by, "bytes_ms": by_bytes, "ops_ms": by_ops,
                "rule": rule, **held,
            }
        del out, ref

    with torch.inference_mode():
        h1 = K.layernorm_rows(x, ln1s, ln1b)
        qkv = K.gemm_bias_epilogue(h1, wqkv, bqkv, "bias")
    sl = (qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:])

    def heads(t):
        return t.reshape(b, lp, h, dh).transpose(1, 2)

    attn_bytes = 4 * m * d * 2
    keep = (torch.arange(lp, device=dev) < length)[None, :]  # SDPA: True attends
    bf16_bars = BARS["bfloat16"]
    entry("attention_packed.q_round", bf16_bars,
          lambda: K.attention_packed(*sl, h, False, length, "q_round"),
          lambda: K.fused_attention_packed_plain(*sl, h, False, length, "q_round"),
          lambda: F.scaled_dot_product_attention(*map(heads, sl), attn_mask=keep),
          attn_bytes, 4 * b * lp * length * d)
    entry("attention_packed.no_softmax", bf16_bars,
          lambda: K.attention_packed(*sl, h, False, length, "no_softmax"),
          lambda: K.fused_attention_packed_plain(*sl, h, False, length, "no_softmax"),
          None, attn_bytes, 4 * b * lp * lp * d)
    entry("attention_int8", int8_attention_rule(sl[2]),
          lambda: K.attention_int8(*sl, h, length, geom.group),
          lambda: K.attention_int8_plain(*sl, h, length, geom.group),
          lambda: F.scaled_dot_product_attention(*map(heads, sl), attn_mask=keep),
          attn_bytes, {"int8": 4 * b * lp * length * d})
    entry("qkv_sum", "exact", lambda: K.qkv_sum(qkv), lambda: K.qkv_sum_plain(qkv),
          lambda: qkv.view(m, 3, d).sum(dim=1), m * 4 * d * 2, 2 * m * d)
    with torch.inference_mode():
        h2 = K.layernorm_rows(x, ln2s, ln2b)
        hid = K.gemm_bias_epilogue(h2, wfc, bfc, "bias_gelu")
        attn = K.attention_packed(*sl, h, False, length)
    entry("gemm_bias_epilogue.bias_gelu_bf16", bf16_bars,
          lambda: K.gemm_bias_epilogue(h2, wfc, bfc, "bias_gelu_bf16"),
          lambda: K.gemm_bias_epilogue_plain(h2, wfc, bfc, "bias_gelu_bf16"),
          lambda: K.quick_gelu_rounded(torch.addmm(bfc, h2.view(m, d), wfc)),
          (m * d + 4 * d * d + 4 * d + m * 4 * d) * 2, 8 * m * d * d)
    w_down = q8[16]
    entry("gemm_bias_epilogue.bias32_residual", bf16_bars,
          lambda: K.gemm_bias_epilogue(hid, w_down, q8[15], "bias32_residual", residual=x),
          lambda: K.gemm_bias_epilogue_plain(hid, w_down, q8[15], "bias32_residual", residual=x),
          lambda: torch.addmm(q8[15].to(bf16), hid.view(m, 4 * d), w_down) + x.view(m, d),
          (m * 4 * d + 4 * d * d + 2 * m * d) * 2 + d * 4, 8 * m * d * d)
    for mode in ("recip", "static", "cast"):
        entry(f"quant_rows.{mode}", "exact", lambda mode=mode: K.quant_rows(attn, mode),
              lambda mode=mode: K.quant_rows_plain(attn, mode), None,
              m * d * 2 + m * d + m * 4, 3 * m * d, "float32")
        entry(f"layernorm_quant_rows.{mode}", "ln_quant",
              lambda mode=mode: K.layernorm_quant_rows(x, ln1s, ln1b, mode=mode),
              lambda mode=mode: K.layernorm_quant_rows_plain(x, ln1s, ln1b, mode=mode), None,
              m * d * 2 + m * d + m * 4 + 2 * d * 4, 10 * m * d, "float32")
    entry("layernorm_quant_rows.bf16_stats", "ln_quant_bf16_stats",
          lambda: K.layernorm_quant_rows(x, ln1s, ln1b, bf16_stats=True),
          lambda: K.layernorm_quant_rows_plain(x, ln1s, ln1b, bf16_stats=True), None,
          m * d * 2 + m * d + m * 4 + 2 * d * 4, 12 * m * d, "float32")
    with torch.inference_mode():
        h_q = K.layernorm_quant_rows(x, ln2s, ln2b)
    wfc_q, sfc, bfc32 = q8[10], q8[11], q8[12]
    for epi, out_b in (("dequant_bias_gelu_bf16", 2), ("dequant_bias_f32", 4),
                       ("dequant_bias_gelu_round", 2)):
        args = (*h_q, wfc_q, sfc, bfc32, epi, bf16)

        def library(epi=epi):
            y = torch._int_mm(h_q[0].view(m, d), wfc_q.t()).float() * h_q[1].view(m, 1) * sfc + bfc32
            if epi == "dequant_bias_f32":
                return y
            if epi == "dequant_bias_gelu_bf16":
                return K.quick_gelu_rounded(y.to(bf16))
            return (y * torch.sigmoid(1.702 * y)).to(bf16)

        entry(f"gemm_int8_epilogue.{epi}", "ulp" if epi == "dequant_bias_gelu_bf16" else "exact",
              lambda args=args: K.gemm_int8_epilogue(*args),
              lambda args=args: K.gemm_int8_epilogue_plain(*args), library,
              m * d + 4 * d * d + 4 * (m + 8 * d) + m * 4 * d * out_b, {"int8": 8 * m * d * d})
    del h1, h2, hid, attn, h_q
    torch.cuda.empty_cache()
    # one block of each S1 site, as the bench's variants run it
    sites = (("bench_block_bf16", "v2"), ("bench_mlp_bf16", "micro:mlp_pallas"),
             ("bench_mlp_int8", "micro:int8mlp"), ("bench_qkv_int8", "micro:int8qkv"),
             ("bench_attn_bf16", "micro:attn_pallas"), ("bench_block_int8", "int8s"))
    for site, name in sites:
        prep = next(bench.iter_prepared([name], geom, dev))
        _, attention = variant_site(prep)
        n_bytes, ops = site_work(site, b, lp, length, d, attention)
        layer0 = prep.layers[0]
        entry(site, SITE_BARS["int8" if "int8" in site else "bf16"],
              lambda prep=prep, layer0=layer0: prep.block(prep.x, layer0, bv.KERNEL_OPS),
              lambda prep=prep, layer0=layer0: prep.block(prep.x, layer0, bv.PLAIN_OPS), None,
              n_bytes, ops)
        r[site]["variant"] = name
        del prep, layer0
        torch.cuda.empty_cache()
    emit({"phase": "variant_times", "batch": b, "padded_rows": lp, "L": length, "D": d,
          "heads": h, "kernels": r})
    bad = [name for name, row in r.items() if not row["ok"]]
    require(not bad, f"bench kernels off their plain versions at the bench geometry: {bad}")
    return r


# -- 9. the contract line ------------------------------------------------------------

PALLAS = "protoclip_tpu/ops/pallas_kernels.py"
KERNEL_SOURCES = {  # name: (source, TPU function it replaces, the run that launches it)
    "layernorm_rows": ("protoclip_tpu_torch/csrc/layernorm_rows.cu", f"{PALLAS}:263", "main"),
    "gemm_bias_epilogue": ("protoclip_tpu_torch/csrc/gemm_bias_epilogue.cu", f"{PALLAS}:275",
                           "main"),
    "attention_packed": ("protoclip_tpu_torch/csrc/attention_packed.cu", f"{PALLAS}:145", "main"),
    "fused_transformer_block": ("protoclip_tpu_torch/ops/kernels.py", f"{PALLAS}:252", "main"),
    "fused_attention_packed": ("protoclip_tpu_torch/csrc/attention_packed.cu", f"{PALLAS}:218",
                               "check"),
    "layernorm_quant_rows": ("protoclip_tpu_torch/csrc/quant_rows.cu", f"{PALLAS}:527",
                             "main_int8"),
    "quant_rows": ("protoclip_tpu_torch/csrc/quant_rows.cu", f"{PALLAS}:500", "main_int8"),
    "gemm_int8_epilogue": ("protoclip_tpu_torch/csrc/gemm_int8_epilogue.cu", f"{PALLAS}:508",
                           "main_int8"),
    "fused_transformer_block_int8": ("protoclip_tpu_torch/ops/kernels.py", f"{PALLAS}:516",
                                     "main_int8"),
    "fused_attention": ("protoclip_tpu_torch/csrc/attention_packed.cu", f"{PALLAS}:65", "check"),
}
BENCH = "scripts/bench_block_variants.py"
CSRC = "protoclip_tpu_torch/csrc/"
KERNEL_SOURCES.update({  # the block-variant bench (S1): its modes, its kernels, its sites
    "attention_packed.q_round": (CSRC + "attention_packed.cu", f"{BENCH}:212", "variants"),
    "attention_packed.no_softmax": (CSRC + "attention_packed.cu", f"{BENCH}:664", "variants"),
    "gemm_bias_epilogue.bias_gelu_bf16": (CSRC + "gemm_bias_epilogue.cu", f"{BENCH}:274",
                                          "variants"),
    "gemm_bias_epilogue.bias32_residual": (CSRC + "gemm_bias_epilogue.cu", f"{BENCH}:893",
                                           "variants"),
    "gemm_int8_epilogue.dequant_bias_gelu_bf16": (CSRC + "gemm_int8_epilogue.cu",
                                                  f"{BENCH}:884", "variants"),
    "gemm_int8_epilogue.dequant_bias_f32": (CSRC + "gemm_int8_epilogue.cu", f"{BENCH}:516",
                                            "variants"),
    "gemm_int8_epilogue.dequant_bias_gelu_round": (CSRC + "gemm_int8_epilogue.cu",
                                                   f"{BENCH}:886", "variants"),
    "quant_rows.recip": (CSRC + "quant_rows.cu", f"{BENCH}:758", "variants"),
    "quant_rows.static": (CSRC + "quant_rows.cu", f"{BENCH}:777", "variants"),
    "quant_rows.cast": (CSRC + "quant_rows.cu", f"{BENCH}:788", "variants"),
    "layernorm_quant_rows.recip": (CSRC + "quant_rows.cu", f"{BENCH}:758", "variants"),
    "layernorm_quant_rows.static": (CSRC + "quant_rows.cu", f"{BENCH}:777", "variants"),
    "layernorm_quant_rows.cast": (CSRC + "quant_rows.cu", f"{BENCH}:788", "variants"),
    "layernorm_quant_rows.bf16_stats": (CSRC + "quant_rows.cu", f"{BENCH}:798", "variants"),
    "attention_int8": (CSRC + "attention_int8.cu", f"{BENCH}:1023", "variants"),
    "qkv_sum": (CSRC + "qkv_sum.cu", f"{BENCH}:583", "variants"),
    "bench_block_bf16": ("protoclip_tpu_torch/ops/block_variants.py", f"{BENCH}:304", "variants"),
    "bench_mlp_bf16": ("protoclip_tpu_torch/ops/block_variants.py", f"{BENCH}:462", "variants"),
    "bench_mlp_int8": ("protoclip_tpu_torch/ops/block_variants.py", f"{BENCH}:529", "variants"),
    "bench_qkv_int8": ("protoclip_tpu_torch/ops/block_variants.py", f"{BENCH}:589", "variants"),
    "bench_attn_bf16": ("protoclip_tpu_torch/ops/block_variants.py", f"{BENCH}:687", "variants"),
    "bench_block_int8": ("protoclip_tpu_torch/ops/block_variants.py", f"{BENCH}:947", "variants"),
})


def phase_kernels(counts, times, vtimes):
    """One entry per ported kernel, timed at the image block (ViT-B/16,
    B=256), or, for the bench's modes, kernels and sites, at the bench's
    geometry (B=512, LP=200).  ``launches`` is the count of the run named by
    ``path``: the bf16 main path, the int8 main path, the bench's variants,
    or, for K1 and K4, which no path runs, the check phase; for an S1 site
    it is the site's blocks run on the kernels, each a chain of the kernel
    launches counted in the other rows.  The parts of a
    kernel timed apiece (the four GEMMs of a block, quant_rows on the
    attention output and on the fp32 hidden) are summed.  ``ms`` is the
    CUDA-event time of one call (with the host's time to reach the launch),
    ``device_ms`` the same call's device time (:func:`device_ms`)."""
    image = times["image"]["kernels"]
    rows = []
    for name, (source, replaces, path) in KERNEL_SOURCES.items():
        if path == "variants":
            parts = [vtimes[name]]
        else:
            parts = [v for k, v in image.items() if k == name or k.startswith(name + ".")]
        lib = [pt["library_ms"] for pt in parts]
        by_bytes, by_ops = sum(pt["bytes_ms"] for pt in parts), sum(pt["ops_ms"] for pt in parts)
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "path": path, "launches": counts[path][name],
            "launches_by_path": {run: c.get(name, 0) for run, c in counts.items()},
            "max_abs_err": max(pt["max_abs_err"] for pt in parts),
            "ms": sum(pt["ms"] for pt in parts),
            "device_ms": sum(pt["device_ms"] for pt in parts),
            "plain_ms": sum(pt["plain_ms"] for pt in parts),
            "bound_ms": sum(pt["bound_ms"] for pt in parts),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None if None in lib else sum(lib),
        })
    for row in rows:
        require(row["launches"] > 0, f"{row['name']} was not launched in its run ({row['path']})")
    emit({"kernels": rows})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA card",
              file=sys.stderr)
        return 2
    import numpy as np

    from protoclip_tpu_torch.ops import kernels as K

    info = phase_device(torch)
    phase_build()
    K.reset_launch_counts()
    phase_check(torch, np)
    counts = {"check": K.launch_counts()}
    cfg, params, counts["main"], data, ref = phase_main(torch, np)
    _, qparams, counts["main_int8"] = phase_main_int8(torch, np, data, ref)
    rn_cfg, rn_params, counts["runner"] = phase_runner(torch, np)
    times = phase_times(torch, np, params, qparams)
    phase_encode_times(torch, cfg, params, qparams, rn_cfg, rn_params)
    del params, qparams, rn_params
    torch.cuda.empty_cache()
    _, counts["variants"] = phase_variants(torch, np)
    vtimes = phase_variant_times(torch, np)
    phase_kernels(counts, times, vtimes)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
