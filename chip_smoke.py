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
7. train   - Proto-CLIP-F at ImageNet's shape (``configs/imagenet.yml``:
             N = 1000, K = 16, RN50's d = 1024, conv-2x, visual bank only)
             on seeded unit features: ``EpisodicTrainer`` for 20 epochs on
             the card (ms per epoch, episodes and AdamW steps, the loss
             curve), its first 2 epochs held against the fp32 CPU run, a
             run resumed from a snapshot at epoch 10 held bit for bit
             against the straight one; then ``run(only_test=False)`` with
             snapshots and a ``resume=True`` run on the runner phase's
             tree and caches (no encode, no launch), whose saved triple
             must score ``test_acc_fixed``.
8. train_qt - F-Q^T through ``train.qt_runner.run_qt`` on ViT-B/16 at full
             width (bf16, random weights) on a synthetic caltech101 tree of
             10 x 16 train JPEGs, batch 64, 3 epochs: step ms, images/s, K2
             launched 12 times every step, the CLIP parameters bit for bit
             unchanged and the banks and adapter moved; one step held
             against the CPU in fp32 (query features, loss, parameters).
9. toolkit - the deployment toolkit on ViT-L/14 at full width (bf16,
             random weights) with configs/fewsol_198.yml's classifier over a
             FewSOL-198-shaped triple (198 classes x K = 16, fc adapter):
             ``toolkit.ProtoClipClassifier`` (buckets 1, 8, 16) on the robot
             path without ROS (a 480 x 640 RGB-D frame -> crops ->
             ``classify_objects`` -> ``select_spoken_target``, held against
             its rule -> 3-D boxes -> the canvas), K2 launched once a layer a
             classify call; 8 canvases held against the same classifier in
             fp32 on the CPU (features, top-k, buckets, a model swap); the
             classify call's host ms, device ms and idle share at 1, 8 and 16
             canvases; all of it again in the W8A8 mode (K3); and
             ``toolkit.test_ood_performance`` on an imagenet_v2-layout tree,
             its accuracy against the CPU's, then from its cache with no
             launch.
10. serve  - serving through its entry points: ViT-B/16 bundles written by
             ``cli.export`` (batch 256, buckets 8 and 64; bf16 and W8A8),
             loaded with one CUDA graph per bucket; each replay held
             against the eager encode of its bucket (bit for bit, bar
             1e-5), each bucket's rows against the full batch's (bf16 1e-5;
             int8 1e-2, row cosine 0.9995) and the features against the
             fp32 CPU encode; replay against eager ms per bucket; then
             ``cli.serve.build_server`` over the bf16 bundle and the
             toolkit phase's ViT-L/14 classifier, driven by
             ``client.ServeClient`` threads in a process of their own
             (``chip_smoke.py --loadgen``) at concurrency 1, 8 and 32 with
             seeded 480 x 640 JPEGs, each for a window of >= 4 s and >= 200
             requests (requests/s, images/s, p50/p99, the client's own
             base64/JSON ms apart, fill, both processes' CPU cores), the
             served answers held against direct calls, the protocol's
             errors, and the serve CLI in a subprocess (SIGTERM, exit 0).
             The host preprocess runs natively ($PROTOCLIP_NATIVE=1); its
             decode + preprocess ms is also timed through PIL on the same
             JPEGs (and on the toolkit phase's crops).
11. mesh   - the data mesh (``protoclip_tpu_torch.parallel``) at full
             width on the one card (ViT-B/16, random weights, bf16 and
             W8A8): ``train.runner.make_encode_fns(cfg, make_mesh(1))`` on a
             B=256 batch bit for bit the unsharded encode (K2 / K3 12 an
             encode); two 128-row shards on cuda:0 against it (cosine
             >= 0.99999, max abs error and exactness reported); one NCCL
             rank and one sharded F-Q^T step (batch 64) against the
             unsharded step, bit for bit; two processes of this script
             (``--mesh-rank``) over gloo on cuda:0: the gathered features
             against the one-process encode, the gather's ms, one Q^T step
             whose parameters agree bit for bit across the ranks; the serve
             CLI's mesh route (32 rows a device) over HTTP and ``cli.extract
             --mesh 1``, each bit for bit the direct call; images/s of the
             mesh encodes against the unsharded one (wiring cost on one
             card, not scaling).
12. experiment - the port's validators through their own ``main()``s
             (random weights, seed 0; the synthetic tokenizer):
             ``scripts.validate_accuracy --only fewsol_198 --int8`` with the
             shipped configs/fewsol_198.yml (only_test) on ViT-L/14 at full
             width over a FewSOL-198-layout tree of 480 x 640 JPEGs (shots
             16 -> 4, augment_epoch 10 -> 2, 2 val and 2 test a class; the
             cuts listed as ``reduced``): no ERROR or skip row, K2 once a
             layer an encode in bf16, K3 and no K2 in int8, both reruns from
             the caches with no encode and no launch and the same
             ``test_acc_fixed``, 8 val rows of each mode's cached features
             against the fp32 CPU tower (cosine >= 0.999 / 0.995), the
             zero-shot grid recomputed on the CPU (each cell's count off
             the card's by at most its near ties under fp32 summation
             order) and ``test_acc_fixed`` (within 1e-6); then ``scripts.validate_experiment`` at ViT-B/32:
             a full ``run(only_test=False)`` and its ``only_test`` rerun.
             Wall and bank-build seconds and images/s per mode, encode
             calls, K2/K3 launches and the random-weight accuracies
             (plumbing checks, not results).
13. tools  - the repository's remaining tools, ported under
             ``protoclip_tpu_torch/scripts/``, through their own ``main()``s
             (random weights, seed 0): ``validate_bundle`` on ViT-B/16
             (batch 256, buckets 8 and 64, bf16 and int8: the reloaded
             bundle bit for bit the live encode, each bucket within the JAX
             bars, ms per dispatch; K2 / K3 once a layer a bucket's warm-up,
             capture and the live encode); ``bench_serve_http`` as a
             subprocess over the bf16 bundle (32 requests of 8 images,
             serial then concurrent) and over an int8 one (serial
             dispatches equal the requests; the server stopped, its port
             closed); ``bench_int8_peak`` (N = 8192, 20 steps: ``_int_mm``,
             bf16 ``matmul``, K3.c and K2.b at N^3; the int8 checksum exact,
             K3.c equal to ``_int_mm``, K2.b within bf16's bars of
             ``matmul``); ``bench_rn50_int8`` (RN50's 7 hot conv shapes at
             B = 256: the bf16 conv, im2col + K3.b + K3.c, the pre-quantized
             product and ``_int_mm``, each int8 product within a cosine of
             0.99 of the conv; layer4.conv2's 4608-wide rows, past K3.b's
             4096, have no im2col + K3.b line); ``bench_episodic_sharding``
             at ImageNet's shape on a mesh of the card and on two shards of
             it (the steps of one fixed epoch of episodes, 100 epochs each
             way, in turn; the wiring's cost, not scaling; parameters within
             1e-6).
14. times  - each kernel (CUDA events around one call, and its device
             time: the same with the call queued behind a spinning kernel),
             its plain version, one PyTorch library call for the same
             function and the bound, at the main path's encode batches
             (images B=256, prompts B=1024) and at the classifier's ViT-L/14
             image block (B=16), and the encode rates in bf16 (K2) and int8
             (K3), and RN50's image encode in bf16.
15. variants - the block-variant bench (``python -m protoclip_tpu_torch.
             scripts.bench_block_variants``, the port of
             scripts/bench_block_variants.py) over one variant of each
             distinct chain (23; the TPU script's schedule-only twins are
             left out) at the full ViT-B/16 geometry (B=512, LP=200, 12
             layers) and four at ViT-L/14: ms per stack, checksum, twin,
             bound and launches; each chain held against its plain versions
             (the stack at B=16, layer 0's block and int8s's attention core
             at the full batch), a twin, where one is listed, held to its
             twin's checksum; then each of its
             modes, kernels and sites timed alone and held to its check rule
             at the bench geometry (variant_times), the int8 attention core
             also at ViT-L/14's (B=128, LP=264).
16. kernels - the contract line: every ported kernel with the path or phase
             that launched it, its launches (by path, the runner's, the
             trainers', the server's and the tools' too, and per replay of
             each serving bucket's CUDA graph), error, times and bound.

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
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
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
    from protoclip_tpu_torch.scripts.validate_experiment import describe_device

    smi = describe_device(torch.device("cuda", 0))["power_limit"]
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


def write_caltech_tree(np, root, shots=SHOTS):
    """A synthetic caltech101 tree (the layout of tests/test_e2e.py): N_CLASS
    folders of class-coloured JPEGs, ``shots`` train and N_EVAL / N_CLASS val
    and test images a class, and the CoOp split JSON."""
    from PIL import Image

    np_rng = np.random.default_rng(SEED)
    colours = np_rng.integers(0, 200, (N_CLASS, 3))
    img_dir = os.path.join(root, "caltech-101", "101_ObjectCategories")
    rows = {"train": [], "val": [], "test": []}
    per_split = (("train", shots), ("val", N_EVAL // N_CLASS), ("test", N_EVAL // N_CLASS))
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


@contextlib.contextmanager
def counting_encodes(calls):
    """Count the runner's image and text encode calls into ``calls``."""
    from protoclip_tpu_torch.models import encode_image, encode_text
    from protoclip_tpu_torch.train import runner

    def counted(fn, kind):
        def wrapper(*args, **kwargs):
            calls[kind] += 1
            return fn(*args, **kwargs)
        return wrapper

    runner.encode_image = counted(encode_image, "image")
    runner.encode_text = counted(encode_text, "text")
    try:
        yield calls
    finally:
        runner.encode_image, runner.encode_text = encode_image, encode_text


def phase_runner(torch, np, tmp):
    """Test-only Proto-CLIP on RN50 at full width (224 px, layers 3-4-6-3,
    width 64, embed 1024; random weights, seed 0; bf16) through the port's
    own entry points: ``prepare_experiment`` encodes a synthetic caltech101
    tree on the card and writes the caches in the reference's tree under
    ``tmp``, a ``_v/_t/_a`` triple is saved, and ``run(only_test=True)``
    scores it from the caches alone.  The launch counts are set to 0 just
    before each of the two runs and read just after it."""
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

    banks.tokenize = synthetic_tokenize  # the BPE vocab is not in the repository
    with counting_encodes({"image": 0, "text": 0}) as calls:
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
    return clip_cfg, setup, prepare_counts, cfg


def damped_resnet(visual):
    """A ResNet tower whose residual branches are scaled by RN_DAMP (each
    Bottleneck's last folded BN), so the activations stay O(1)."""
    out = dict(visual)
    for i in range(1, 5):
        out[f"layer{i}"] = [{**b, "bn3": {"scale": b["bn3"]["scale"] * RN_DAMP,
                                          "bias": b["bn3"]["bias"]}}
                            for b in visual[f"layer{i}"]]
    return out


# -- 7-8. the trainers ---------------------------------------------------------------

IMAGENET_CONFIG, IMAGENET_CLASSES = "configs/imagenet.yml", 1000
TRAIN_EPOCHS, TRAIN_HELD_EPOCHS, TRAIN_RESUME_AT = 20, 2, 10
# card vs CPU fp32, each parameter: max|diff| <= TRAIN_BAR x its max|param| +
# TRAIN_FLOOR.  cuBLAS and cuDNN sum in another order than the CPU (~1e-6 of
# a gradient); the floor, a thousandth of one lr-1e-4 step, holds the
# parameters whose gradient is zero in exact arithmetic (conv-2x's first
# LayerNorm bias feeds a LayerNorm over the whole map), which both devices
# move by rounding noise alone.
TRAIN_BAR, TRAIN_FLOOR = 1e-4, 1e-7
RUNNER_TRAIN_EPOCHS, RUNNER_SNAPSHOT_EVERY = 4, 2


def unit_rows(np, np_rng, n, d):
    x = np_rng.standard_normal((n, d), dtype=np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def param_diffs(torch, params, ref, bar=TRAIN_BAR, floor=TRAIN_FLOOR):
    """{name: (max|diff|, max|diff| / max|ref|)} of two parameter dicts
    (tensors), and the names over ``bar`` x max|ref| + ``floor``."""
    from protoclip_tpu_torch.train.episodic import named_leaves

    want = {n: p.detach().float().cpu() for n, p in named_leaves(ref)}
    out, over = {}, []
    for name, p in named_leaves(params):
        diff = float((p.detach().float().cpu() - want[name]).abs().max())
        scale = float(want[name].abs().max())
        out[name] = (diff, diff / scale if scale else None)
        if diff > bar * scale + floor:
            over.append(name)
    return out, over


def adam_steps(trainer):
    """AdamW's step count (every parameter steps together)."""
    state = trainer.optimizer.state.get(trainer.params["bank_v"], {})
    return int(float(state["step"])) if "step" in state else 0


def cpu_copy(tree):
    return {k: cpu_copy(v) if isinstance(v, dict) else v.detach().cpu().clone()
            for k, v in tree.items()}


def phase_train(torch, np, tmp, runner_cfg, runner_setup):
    """Proto-CLIP-F at ImageNet's shape (``configs/imagenet.yml``: RN50's
    d = 1024, N = 1000, K = 16, conv-2x, train_vis_mem_only, alpha 0.5, beta
    12, lr 1e-4, L1-L3) on seeded random unit features: a 16000 x 1024 fp32
    visual bank.  ``EpisodicTrainer`` runs TRAIN_EPOCHS epochs on the card
    (ms per epoch, episodes and AdamW steps per epoch, the loss curve); the
    first TRAIN_HELD_EPOCHS are held against the port's fp32 CPU run from
    the same adapter; TRAIN_RESUME_AT epochs, a snapshot, a fresh trainer
    restored from it and the rest are held against the straight run.  Then
    ``run(only_test=False)`` on the ``runner`` phase's tree (RN50, its
    caches, so it encodes nothing) with snapshots, and a ``resume=True``
    run; the triple it saves is the one the test phase scores.  The launch
    counts are set to 0 before and read after each card run (no kernel is
    on this path: the trainer runs on cached features)."""
    from protoclip_tpu_torch.core import accuracy, from_arrays, load_config
    from protoclip_tpu_torch.io import checkpoint_paths, load_checkpoint_triple, load_pkl
    from protoclip_tpu_torch.models import BACKBONE_CONFIGS, adapter_from_torch_state, init_adapter
    from protoclip_tpu_torch.ops import kernels as K
    from protoclip_tpu_torch.train import EpisodicTrainer, runner
    from protoclip_tpu_torch.train.episodic import make_episode_queries
    from protoclip_tpu_torch.train.resume import load_train_state, save_train_state

    cfg = load_config(IMAGENET_CONFIG)
    n, k, d = IMAGENET_CLASSES, cfg.shots, BACKBONE_CONFIGS[cfg.backbone].embed_dim
    np_rng = np.random.default_rng(SEED)
    keys, bank_t = unit_rows(np, np_rng, n * k, d), unit_rows(np, np_rng, n, d)
    args = dict(frozen_keys=keys, bank_t_init=bank_t, n_class=n, k_shots=k,
                adapter_kind=cfg.adapter, alpha=cfg.alpha, beta=cfg.beta, lr=cfg.lr,
                train_epoch=cfg.train_epoch, losses=tuple(cfg.losses),
                train_vis_mem_only=cfg.train_vis_mem_only, seed=cfg.seed,
                adapter_init=init_adapter(torch.Generator().manual_seed(cfg.seed), d, cfg.adapter))

    def epochs(trainer, count):
        stats = []
        for _ in range(count):
            steps = adam_steps(trainer)
            valid = make_episode_queries(
                np.random.default_rng(trainer.seed + trainer.epoch * 65537), n, k)[3]
            t0 = time.perf_counter()
            out = trainer.run_epoch()  # ends in a synchronizing read of its sums
            ms = (time.perf_counter() - t0) * 1e3
            require(adam_steps(trainer) - steps == int(valid.sum()),
                    f"{adam_steps(trainer) - steps} AdamW steps for {int(valid.sum())} episodes")
            stats.append({**out, "ms": ms, "episodes": int(valid.sum()),
                          "adamw_steps": adam_steps(trainer) - steps})
        return stats

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    card = EpisodicTrainer(**args)
    curve = epochs(card, TRAIN_HELD_EPOCHS)
    held = cpu_copy(card.params)
    curve += epochs(card, TRAIN_EPOCHS - TRAIN_HELD_EPOCHS)
    counts = K.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    for row in curve:
        require(np.isfinite(row["loss"]) and 0.0 <= row["acc"] <= 1.0, f"epoch stats {row}")
    require(curve[-1]["loss"] < curve[0]["loss"], "the loss did not fall in 20 epochs")

    t0 = time.perf_counter()
    cpu = EpisodicTrainer(**args, device="cpu")
    cpu_curve = epochs(cpu, TRAIN_HELD_EPOCHS)
    cpu_s = time.perf_counter() - t0
    diffs, over = param_diffs(torch, held, cpu.params)
    loss_diffs = [abs(a["loss"] - b["loss"]) for a, b in zip(curve, cpu_curve)]
    require(not over and max(ld / b["loss"] for ld, b in zip(loss_diffs, cpu_curve)) <= TRAIN_BAR,
            f"card vs CPU after {TRAIN_HELD_EPOCHS} epochs: {diffs}, loss {loss_diffs}")

    path = os.path.join(tmp, "imagenet_train_state.pkl")
    half = EpisodicTrainer(**args)
    epochs(half, TRAIN_RESUME_AT)
    save_train_state(path, half, extra={"at": TRAIN_RESUME_AT})
    resumed = EpisodicTrainer(**args)
    require(load_train_state(path, resumed) == (TRAIN_RESUME_AT, {"at": TRAIN_RESUME_AT}),
            "the snapshot's epoch")
    epochs(resumed, TRAIN_EPOCHS - TRAIN_RESUME_AT)
    resume_diffs, resume_over = param_diffs(torch, resumed.params, card.params, 0.0, 0.0)
    bit_exact = not resume_over
    require(bit_exact, f"resumed vs straight run: {resume_diffs} (cuDNN deterministic was set)")

    # where an epoch's time goes: the host's sampler alone, and one more
    # epoch's device time under the profiler
    t0 = time.perf_counter()
    make_episode_queries(np.random.default_rng(resumed.seed + resumed.epoch * 65537), n, k)
    sampler_ms = (time.perf_counter() - t0) * 1e3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        resumed.run_epoch()
        torch.cuda.synchronize()
    profiled = device_ms_by_kind(prof, "epoch")
    del card, half, resumed, held
    torch.cuda.empty_cache()

    # the runner on the runner phase's tree: trains from its caches
    cfg_r = dataclasses.replace(runner_cfg, only_test=False, train_epoch=RUNNER_TRAIN_EPOCHS,
                                snapshot_every=RUNNER_SNAPSHOT_EVERY)
    runs = {}
    with counting_encodes({"image": 0, "text": 0}) as calls:
        for name, cfg_run in (("train", cfg_r), ("resume", dataclasses.replace(cfg_r, resume=True))):
            calls.update(image=0, text=0)
            torch.cuda.synchronize()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            result = runner.run(cfg_run, progress=False)
            torch.cuda.synchronize()
            runs[name] = {"s": time.perf_counter() - t0, "encode_calls": dict(calls),
                          "launches": K.launch_counts(), "result": result}
    for name, r in runs.items():
        require(r["encode_calls"] == {"image": 0, "text": 0} and not any(r["launches"].values()),
                f"run({name}) encoded {r['encode_calls']} with launches {r['launches']}")
    a, b = runs["train"]["result"], runs["resume"]["result"]
    require(a.best_epoch >= 0 and (a.best_val_acc, a.best_epoch, a.test_acc_fixed)
            == (b.best_val_acc, b.best_epoch, b.test_acc_fixed),
            f"resumed run {b} differs from {a}")
    paths = checkpoint_paths(cfg_r.cache_dir, cfg_r.backbone, cfg_r.shots, cfg_r.alpha,
                             cfg_r.beta, cfg_r.lr, cfg_r.augment_epoch, cfg_r.train_epoch)
    snapshot = load_pkl(runner.snapshot_path(paths[0]))
    require(snapshot["epoch"] == RUNNER_TRAIN_EPOCHS, f"snapshot at epoch {snapshot['epoch']}")
    bank_v, bank_t_r, state = load_checkpoint_triple(*paths)
    model = from_arrays(bank_v, bank_t_r, adapter_from_torch_state(state, cfg_r.adapter),
                        cfg_r.adapter, cfg_r.shots)
    acc = accuracy(model, runner_setup.test_feats, runner_setup.test_labels, cfg_r.alpha,
                   cfg_r.beta)
    require(abs(acc - a.test_acc_fixed) <= 1e-6,
            f"test_acc_fixed {a.test_acc_fixed} but the saved triple scores {acc}")

    ms = sorted(row["ms"] for row in curve)
    emit({"phase": "train", "config": IMAGENET_CONFIG, "n_class": n, "shots": k, "d": d,
          "adapter": cfg.adapter, "train_vis_mem_only": cfg.train_vis_mem_only,
          "alpha": cfg.alpha, "beta": cfg.beta, "lr": cfg.lr, "losses": list(cfg.losses),
          "features": "seeded random unit rows", "bank_v": [n * k, d], "epochs": TRAIN_EPOCHS,
          "median_ms_per_epoch": ms[len(ms) // 2], "first_epoch_ms": curve[0]["ms"],
          "ms_per_epoch": [row["ms"] for row in curve],
          "episodes_per_epoch": [row["episodes"] for row in curve],
          "adamw_steps_per_epoch": [row["adamw_steps"] for row in curve],
          "loss_curve": [row["loss"] for row in curve], "acc_curve": [row["acc"] for row in curve],
          "peak_memory_gib": peak_gb, "launches": counts,
          "vs_cpu_fp32": {"epochs": TRAIN_HELD_EPOCHS, "cpu_s": cpu_s, "bar": TRAIN_BAR,
                          "floor": TRAIN_FLOOR, "loss_abs_diff": loss_diffs,
                          "max_abs_diff_and_rel_by_param": diffs},
          "resume": {"at": TRAIN_RESUME_AT, "of": TRAIN_EPOCHS, "bit_exact": bit_exact},
          "host_sampler_ms": sampler_ms, **profiled,
          "runner": {"backbone": cfg_r.backbone, "epochs": RUNNER_TRAIN_EPOCHS,
                     "snapshot_every": RUNNER_SNAPSHOT_EVERY,
                     "train_s": runs["train"]["s"], "resume_s": runs["resume"]["s"],
                     "encode_calls": runs["train"]["encode_calls"],
                     "best_val_acc": a.best_val_acc, "best_epoch": a.best_epoch,
                     "test_acc_fixed": a.test_acc_fixed,
                     "test_acc_fixed_of_saved_triple": acc,
                     "test_acc_searched": a.test_acc_searched}})
    return counts


QT_BACKBONE, QT_SHOTS, QT_BATCH, QT_EPOCHS = "ViT-B/16", 16, 64, 3
# one Q^T step, card vs CPU: on the card's own query features the CPU's fp32
# step within TRAIN_BAR (as above); against the CPU's fp32 features (row
# cosine >= 0.999 in bf16), the loss within 1e-2 of its size and the update
# of all parameters at a cosine >= 0.99
QT_LOSS_BAR, QT_UPDATE_COSINE = 1e-2, 0.99


def phase_train_qt(torch, np, tmp):
    """Proto-CLIP-F-Q^T through ``train.qt_runner.run_qt`` on ViT-B/16 at full
    width (224 px, 12 layers, D = 768; random weights, seed 0; bf16) on a
    synthetic caltech101 tree of N_CLASS x QT_SHOTS train JPEGs, batch
    QT_BATCH, QT_EPOCHS epochs (caltech101's operating point, with the
    textual bank trained).  Every step's frozen encode must launch K2 once a
    layer; the CLIP parameters must stay bit for bit and the banks and the
    adapter move.  Then the first batch's step again on fresh trainers: on
    the card, and in fp32 on the CPU (on the card's features and on its
    own).  The launch counts are set to 0 before ``run_qt`` and read after
    it."""
    from protoclip_tpu_torch.core import Config
    from protoclip_tpu_torch.memory import banks
    from protoclip_tpu_torch.models import init_adapter, load_clip
    from protoclip_tpu_torch.ops import kernels as K
    from protoclip_tpu_torch.train import QTTrainer
    from protoclip_tpu_torch.train.episodic import named_leaves
    from protoclip_tpu_torch.train.qt_runner import run_qt

    banks.tokenize = synthetic_tokenize
    root = os.path.join(tmp, "DATA_QT")
    write_caltech_tree(np, root, shots=QT_SHOTS)
    cfg = Config(dataset="caltech101", root_path=root, shots=QT_SHOTS, backbone=QT_BACKBONE,
                 augment_epoch=AUGMENT, alpha=0.8, beta=9.0, adapter="conv-3x", lr=1e-4,
                 train_epoch=QT_EPOCHS, batch_size=QT_BATCH, only_test=False,
                 cache_root=os.path.join(tmp, "caches_qt"),
                 logs_dir_path=os.path.join(tmp, "logs_qt"), compute_dtype="bfloat16")

    steps, seen = [], {}
    train_step = QTTrainer.train_step

    def timed_step(self, images, labels, n_valid):
        if not seen:
            seen.update(trainer=self, batch=(images.copy(), labels.copy(), n_valid),
                        clip=[t.clone() for t in tensors(self.clip_params)])
        torch.cuda.synchronize()
        k2 = K.launch_counts()["fused_transformer_block"]
        t0 = time.perf_counter()
        out = train_step(self, images, labels, n_valid)  # ends in a synchronizing read
        steps.append({"s": time.perf_counter() - t0, "t_end": time.perf_counter(),
                      "k2": K.launch_counts()["fused_transformer_block"] - k2,
                      "n_valid": n_valid, "epoch": self.epoch})
        return out

    QTTrainer.train_step = timed_step
    try:
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        result = run_qt(cfg, progress=False)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = K.launch_counts()
    finally:
        QTTrainer.train_step = train_step

    trainer = seen["trainer"]
    layers = trainer.clip_cfg.vision_layers
    per_epoch = -(-N_CLASS * QT_SHOTS // QT_BATCH)
    require(len(steps) == QT_EPOCHS * per_epoch, f"{len(steps)} steps")
    require(all(st["k2"] == layers for st in steps) and counts["fused_transformer_block"] > 0,
            f"K2 launches per step {[st['k2'] for st in steps]}, expected {layers}")
    require(all(torch.equal(a, b) for a, b in zip(tensors(trainer.clip_params), seen["clip"])),
            "the CLIP parameters changed in training")
    init = {"bank_v": trainer.bank_v_init, "bank_t": trainer.bank_t_init}
    adapter0 = init_adapter(torch.Generator().manual_seed(cfg.seed), trainer.bank_v_init.shape[1],
                            cfg.adapter)
    init.update({f"adapter/{name}": v for name, v in named_leaves(adapter0)})
    moved = {name: float((p.detach().float().cpu() - torch.as_tensor(init[name])).abs().max())
             for name, p in named_leaves(trainer.params)}
    require(moved["bank_v"] > 0 and moved["bank_t"] > 0
            and any(v > 0 for name, v in moved.items() if name.startswith("adapter/")),
            f"parameters that moved: {moved}")
    step_s = sorted(st["s"] for st in steps)
    loops = []
    for e in range(QT_EPOCHS):
        ep = [st for st in steps if st["epoch"] == e]
        loops.append(sum(st["n_valid"] for st in ep[1:])
                     / max(ep[-1]["t_end"] - ep[0]["t_end"], 1e-9))

    # the first batch's step, card vs CPU fp32
    images, labels, n_valid = seen["batch"]
    kw = dict(bank_v_init=trainer.bank_v_init, bank_t_init=trainer.bank_t_init,
              n_class=trainer.n_class, k_shots=trainer.k_shots, adapter_kind=cfg.adapter,
              alpha=cfg.alpha, beta=cfg.beta, lr=cfg.lr, train_epoch=cfg.train_epoch,
              seed=cfg.seed, adapter_init=adapter0)
    _, cpu_params = load_clip(QT_BACKBONE, dtype=torch.float32, device="cpu", seed=0)
    card = QTTrainer(clip_params=trainer.clip_params, clip_cfg=trainer.clip_cfg, **kw)
    cpu_own = QTTrainer(clip_params=cpu_params, clip_cfg=trainer.clip_cfg, device="cpu",
                        compute_dtype="float32", **kw)
    cpu_on_card = QTTrainer(clip_params=cpu_params, clip_cfg=trainer.clip_cfg, device="cpu",
                            compute_dtype="float32", **kw)
    zq_card, zq_cpu = card.encode(images), cpu_own.encode(images)
    cos = row_cosines(torch, zq_card.cpu(), zq_cpu)[:n_valid]
    got = card.step_on_features(zq_card, labels, n_valid)
    want = cpu_on_card.step_on_features(zq_card.cpu(), labels, n_valid)
    full = cpu_own.step_on_features(zq_cpu, labels, n_valid)
    diffs, over = param_diffs(torch, card.params, cpu_on_card.params)
    init_t = {name: torch.as_tensor(v).float() for name, v in init.items()}
    upd_card = torch.cat([(p.detach().cpu() - init_t[name]).flatten()
                          for name, p in named_leaves(card.params)])
    upd_cpu = torch.cat([(p.detach() - init_t[name]).flatten()
                         for name, p in named_leaves(cpu_own.params)])
    upd_cos = float(upd_card @ upd_cpu / (upd_card.norm() * upd_cpu.norm()))
    loss_rel = abs(got["loss"] - full["loss"]) / abs(full["loss"])
    require(float(cos.min()) >= 0.999, f"query features card vs CPU fp32: cosines {cos.tolist()}")
    require(not over and abs(got["loss"] - want["loss"]) <= TRAIN_BAR * abs(want["loss"]),
            f"step on the card's features, card vs CPU: {diffs}, loss {got} vs {want}")
    require(loss_rel <= QT_LOSS_BAR and upd_cos >= QT_UPDATE_COSINE,
            f"step card (bf16) vs CPU fp32: loss {got['loss']} vs {full['loss']}, "
            f"update cosine {upd_cos}")
    del cpu_params, cpu_own, cpu_on_card

    # the same step with no loader decoding beside it, and its device time
    quiet = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card.train_step(images, labels, n_valid)
        quiet.append((time.perf_counter() - t0) * 1e3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        card.train_step(images, labels, n_valid)
        torch.cuda.synchronize()
    profiled = device_ms_by_kind(prof, "step")
    del card

    emit({"phase": "train_qt", "backbone": QT_BACKBONE, "dtype": "bfloat16",
          "weights": "random, seed 0", "dataset": "synthetic caltech101 tree",
          "n_class": N_CLASS, "shots": QT_SHOTS, "batch": QT_BATCH, "epochs": QT_EPOCHS,
          "adapter": cfg.adapter, "steps": len(steps), "run_qt_s": run_s,
          "median_step_ms": step_s[len(step_s) // 2] * 1e3,
          "step_ms": [st["s"] * 1e3 for st in steps],
          "train_step_images_per_s": sum(st["n_valid"] for st in steps) / sum(step_s),
          "loop_images_per_s_by_epoch": loops,
          "quiet_step_ms": sorted(quiet)[len(quiet) // 2], **profiled,
          "k2_launches_per_step": [st["k2"] for st in steps], "launches": counts,
          "clip_params_bit_identical": True, "max_abs_moved": moved,
          "best_val_acc": result.best_val_acc, "best_epoch": result.best_epoch,
          "test_acc_fixed": result.test_acc_fixed,
          "one_step_vs_cpu_fp32": {
              "feature_cosines": cos.tolist(), "loss_card": got["loss"],
              "loss_cpu_on_card_features": want["loss"], "loss_cpu_fp32": full["loss"],
              "loss_rel_vs_cpu_fp32": loss_rel, "update_cosine_vs_cpu_fp32": upd_cos,
              "on_card_features_max_abs_diff_and_rel_by_param": diffs}})
    return counts


# -- 9. the deployment toolkit: ViT-L/14 at FewSOL-198's shape -------------------------

TOOLKIT_CONFIG = "configs/fewsol_198.yml"
TOOLKIT_MAX_BATCH, TOOLKIT_BUCKETS = 16, (1, 8, 16)  # each bucket is timed full
TOOLKIT_N_CLASS = 198
FRAME_HW = (480, 640)
MIN_SIZE = 5  # crop_object_images' default: masks this narrow are dropped
OOD_CLASSES, OOD_PER_CLASS = 20, 4
# the classify call's device time is read behind a longer spin than the
# kernels' (~100 ms): the spin must outlast the host's time to issue 24
# blocks, which classify_times measures and requires
CLASSIFY_SPIN_CYCLES = 200_000_000


def write_fewsol_triple(torch, np, cfg):
    """A FewSOL-198-shaped ``_v/_t/_a`` triple in the config's cache tree
    (198 classes x K, d = ViT-L/14's 768, the config's adapter; unit rows
    drawn from the seed), written with the port's save_checkpoint_triple.
    Returns its paths."""
    from protoclip_tpu_torch.io import checkpoint_paths, save_checkpoint_triple
    from protoclip_tpu_torch.models import BACKBONE_CONFIGS, adapter_to_torch_state, init_adapter

    d = BACKBONE_CONFIGS[cfg.backbone].embed_dim
    np_rng = np.random.default_rng(SEED)
    paths = checkpoint_paths(cfg.cache_dir, cfg.backbone, cfg.shots, cfg.alpha, cfg.beta,
                             cfg.lr, cfg.augment_epoch, cfg.train_epoch)
    adapter = init_adapter(torch.Generator().manual_seed(SEED), d, cfg.adapter)
    save_checkpoint_triple(*paths, unit_rows(np, np_rng, TOOLKIT_N_CLASS * cfg.shots, d),
                           unit_rows(np, np_rng, TOOLKIT_N_CLASS, d),
                           adapter_to_torch_state(adapter, cfg.adapter))
    return paths


def write_fewsol_checkpoint(torch, np, cfg, root):
    """:func:`write_fewsol_triple` (K = 16, an fc adapter) and a 198-class
    split JSON.  Returns (triple paths, split path)."""
    paths = write_fewsol_triple(torch, np, cfg)
    split = os.path.join(root, "fewsol_splits_198.json")
    rows = [[f"object_{c:03d}/{k}.png", c, f"object_{c:03d}"]
            for c in range(TOOLKIT_N_CLASS) for k in range(cfg.shots)]
    with open(split, "w") as fh:
        json.dump({"train": rows, "val": [], "test": []}, fh)
    return paths, split


def synthetic_rgbd_frame(np):
    """A 480 x 640 RGB-D frame with a segmentation: 9 objects of 60-150 px
    on a table at ~1 m, and 3 masks of 3 x 3 px (below ``MIN_SIZE``, so
    ``crop_object_images`` drops them, and their 3 x 3 erosion leaves one
    point, so ``segmentation_boxes_3d`` drops them too).  Returns (rgb, depth in metres,
    label, score, intrinsics, the ids crop_object_images keeps)."""
    np_rng = np.random.default_rng(SEED)
    h, w = FRAME_HW
    rgb = np_rng.integers(0, 56, (h, w, 3)).astype(np.int64) + 100
    depth = 1.0 + np_rng.uniform(-0.002, 0.002, (h, w))
    label = np.zeros((h, w), np.int32)
    kept = []
    for i in range(9):
        top, left = 20 + (i // 3) * 155, 20 + (i % 3) * 205
        oh, ow = 60 + 10 * i, 80 + 8 * i
        label[top:top + oh, left:left + ow] = i + 1
        rgb[top:top + oh, left:left + ow] = np_rng.integers(0, 200, 3) + np_rng.integers(
            0, 56, (oh, ow, 3))
        depth[top:top + oh, left:left + ow] -= np_rng.uniform(0.05, 0.3) + np_rng.uniform(
            0, 0.02, (oh, ow))
        kept.append(i + 1)
    for j, (top, left) in enumerate(((470, 5), (5, 630), (300, 630))):
        label[top:top + 3, left:left + 3] = 10 + j
    score = np.where(label > 0, 0.9, 0.0).astype(np.float32)
    intrinsics = np.asarray([[525.0, 0, 319.5], [0, 525.0, 239.5], [0, 0, 1]])
    return rgb.astype(np.uint8), depth.astype(np.float32), label, score, intrinsics, kept


def most_predicted_name(names):
    """The class name that appears in most crops' top-k (the first such in
    crop order on a tie): the noun the fake speech command asks for."""
    seen = {}
    for row in names:
        for name in row:
            seen[name] = seen.get(name, 0) + 1
    return max(seen, key=seen.get)


def classify_times(torch, np, clf, canvases, block):
    """Per ``infer_canvases`` call at 1, 8 and 16 canvases: the median host
    wall ms of TIME_RUNS calls after two warm-ups (upload, padding,
    normalization and the read-back included); the host ms to issue the
    call's launches (``_infer`` on the uploaded bucket, not waited for); the
    device ms of its encode and head (:func:`device_ms` behind
    CLASSIFY_SPIN_CYCLES, on normalized images: the normalization's small
    host-to-device copies of its constants wait for the stream, so they
    stay out of the queued call); the launches of one call, which must be
    ``block`` once a layer; and the share of the wall time the device is
    idle."""
    from protoclip_tpu_torch.data import normalize_batch
    from protoclip_tpu_torch.ops import kernels as K

    layers = clf.clip_cfg.vision_layers
    out = {}
    for n in TOOLKIT_BUCKETS:
        batch = canvases[:n]
        clf.infer_canvases(batch)
        clf.infer_canvases(batch)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        clf.infer_canvases(batch)
        torch.cuda.synchronize()
        launches = {k: v for k, v in K.launch_counts().items() if v}
        require(launches.get(block) == layers,
                f"a {n}-canvas classify call launched {launches}, expected {block} x {layers}")
        walls = []
        for _ in range(TIME_RUNS):
            t0 = time.perf_counter()
            clf.infer_canvases(batch)
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = sorted(walls)[len(walls) // 2]
        bucket = next(b for b in clf.batch_buckets if b >= n)
        padded = np.zeros((bucket,) + batch.shape[1:], np.uint8)
        padded[:n] = batch
        dev = torch.from_numpy(padded).cuda()
        issues = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            clf._infer(dev)
            issues.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        images = normalize_batch(dev, clf._dtype)

        def queued():
            return clf._top_k(clf._features(images))

        spin = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        spin[0].record()
        torch.cuda._sleep(CLASSIFY_SPIN_CYCLES)
        spin[1].record()
        t0 = time.perf_counter()
        queued()
        queued_issue = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        spin_ms = spin[0].elapsed_time(spin[1])
        require(spin_ms > queued_issue, f"the spin ({spin_ms} ms) did not cover the host's "
                                        f"issue time ({queued_issue} ms)")
        dev_ms = device_ms(torch, queued, spin_cycles=CLASSIFY_SPIN_CYCLES)
        out[str(n)] = {"bucket": bucket, "host_wall_ms": wall,
                       "host_issue_ms": sorted(issues)[2], "device_ms": dev_ms,
                       "idle_share": 1.0 - dev_ms / wall, "launches": launches,
                       "spin_ms": spin_ms, "queued_issue_ms": queued_issue}
        del dev, images
    return out


def phase_toolkit(torch, np, tmp):
    """The deployment toolkit through its entry points on ViT-L/14 at full
    width (224 px, 24 layers, D = 1024; random weights, seed 0, bf16), with
    ``configs/fewsol_198.yml``'s classifier (fc adapter, K = 16, alpha 0.2,
    beta 12, top_k 5) over a FewSOL-198-shaped triple and split:

    - the robot path without ROS: a synthetic RGB-D frame -> crop_object_
      images -> classify_objects (logged) -> select_spoken_target on a noun
      from the predictions (held against the rule computed directly) ->
      segmentation_boxes_3d -> the prediction canvas; its launch counts are
      set to 0 just before the classify call and read just after;
    - the card against the CPU: 8 canvases through the same classifier in
      fp32 on the CPU (features: row cosine >= 0.999), the CPU's top-k on
      the card's features (within 1e-5, equal ids), padded buckets against
      the full batch, a model swap; an fp32 tower on the card beside them;
    - the classify call timed at 1, 8 and 16 canvases (:func:`classify_times`);
    - all of it again in the W8A8 mode (K3; cosine >= 0.995);
    - ``test_ood_performance`` through ``make_encode_fns`` on an
      imagenet_v2-layout tree of JPEGs with sidecar junk, its accuracy
      against the CPU's from the card's features, and again from its
      FeatureCache, which must launch nothing.

    Returns (the robot path's launches in bf16, in int8, the bf16 and the
    int8 CLIP parameters, the bf16 classifier)."""
    from PIL import Image

    from protoclip_tpu_torch.core import accuracy, from_arrays, load_config
    from protoclip_tpu_torch.data import normalize_batch
    from protoclip_tpu_torch.io import load_checkpoint_triple, save_checkpoint_triple
    from protoclip_tpu_torch.memory import FeatureCache
    from protoclip_tpu_torch.models import adapter_from_torch_state, encode_image
    from protoclip_tpu_torch.models.clip import to_device
    from protoclip_tpu_torch.models.layers import transformer
    from protoclip_tpu_torch.ops import kernels as K
    from protoclip_tpu_torch.ops.proto import l2_normalize
    from protoclip_tpu_torch.toolkit import ProtoClipClassifier, test_ood_performance
    from protoclip_tpu_torch.toolkit.robot import (backproject, crop_object_images,
                                                   segmentation_boxes_3d, select_spoken_target)
    from protoclip_tpu_torch.train.runner import make_encode_fns

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "toolkit")
    cfg = load_config(TOOLKIT_CONFIG, cache_root=os.path.join(root, "caches"),
                      compute_dtype="bfloat16")
    paths, split = write_fewsol_checkpoint(torch, np, cfg, root)
    rgb, depth, label, score, intrinsics, kept = synthetic_rgbd_frame(np)

    def classifier(cfg, device=None):
        t0 = time.perf_counter()
        clf = ProtoClipClassifier(cfg, splits_path=split, max_batch=TOOLKIT_MAX_BATCH,
                                  batch_buckets=TOOLKIT_BUCKETS, device=device)
        torch.cuda.synchronize()
        return clf, time.perf_counter() - t0

    def robot_path(clf, mode):
        crops, mask_ids = crop_object_images(label, rgb, MIN_SIZE)
        require(mask_ids == kept, f"crop_object_images kept {mask_ids}, expected {kept}")
        log_dir = os.path.join(root, f"logs_{mode}")
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        names, probs = clf.classify_objects(crops, log=True, rgb_image=rgb, log_dir=log_dir)
        classify_ms = (time.perf_counter() - t0) * 1e3
        counts = K.launch_counts()
        noun = most_predicted_name(names)
        chosen = select_spoken_target(names, probs, noun)
        # the rule, directly: the highest probability at the noun's position
        at_noun = np.full(len(names), -np.inf)
        for i, row in enumerate(names):
            if noun in row:
                at_noun[i] = probs[i, row.index(noun)]
        want = int(np.argmax(at_noun))
        require(chosen is not None and chosen[0] == want and chosen[1] == at_noun[want],
                f"select_spoken_target chose {chosen}, the rule {want} ({at_noun[want]})")
        boxes = segmentation_boxes_3d(backproject(depth, intrinsics), label, score, depth,
                                      np.eye(4))
        require(boxes.shape == (len(kept), 8) and np.isfinite(boxes).all()
                and sorted(boxes[:, 7].astype(int).tolist()) == kept,
                f"segmentation_boxes_3d gave {boxes.shape}, ids {boxes[:, 7].tolist()}")
        canvas, texts = clf.draw_image_with_top_k_images(crops, names, probs)
        require(canvas.size == (650, max(325, 40 + (len(crops) + 1) // 2 * 160))
                and len(texts) == len(crops), f"canvas {canvas.size}")
        require(len(os.listdir(log_dir)) == 1, "classify_objects wrote no .npy log")
        require(probs.shape == (len(crops), cfg.top_k) and np.isfinite(probs).all()
                and (np.diff(probs, axis=1) <= 0).all(), f"top-k probabilities {probs.shape}")
        # the crops' preprocess through the native resize and through PIL
        # in turns
        pre, canvases = {"native": [], "PIL": []}, {}
        try:
            for _ in range(5):
                for path, gate in (("native", "1"), ("PIL", "0")):
                    os.environ["PROTOCLIP_NATIVE"] = gate
                    t0 = time.perf_counter()
                    canvases[path] = clf._preprocess_crops(crops)
                    pre[path].append((time.perf_counter() - t0) * 1e3 / len(crops))
        finally:
            os.environ["PROTOCLIP_NATIVE"] = "1"
        require(np.array_equal(canvases["native"], canvases["PIL"]),
                "the native preprocess differs from PIL's on the crops")
        return crops, counts, {
            "crops": len(crops), "masks": int(label.max()), "mask_ids_kept": mask_ids,
            "classify_objects_ms": classify_ms, "launches": {k: v for k, v in counts.items() if v},
            "noun": noun, "selected_crop": chosen[0], "selected_mask_id": mask_ids[chosen[0]],
            "selected_prob": chosen[1], "crops_predicting_noun": int(np.isfinite(at_noun).sum()),
            "top1": [row[0] for row in names], "boxes_3d": len(boxes),
            "crop_hw": [list(c.shape[:2]) for c in crops],
            **{f"preprocess_ms_per_crop_{path}": sorted(ms)[2] for path, ms in pre.items()}}

    failures = []

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    def held_against_cpu(clf, cpu, cpu_feats, canvases, bar, bucket_bars):
        """The card's classifier against the CPU's on 8 canvases, its padded
        buckets against the full batch, and a model swap.  The checks are
        collected in ``failures`` and raised after the phase's line."""
        batch = canvases[:8]
        with torch.inference_mode():
            x = torch.from_numpy(canvases).cuda()
            feats = clf._encode(x[:8])
            card_p, card_i = clf._top_k(feats)
            cpu_p, cpu_i = cpu._top_k(feats.cpu())
            # the image tower's stack of fused blocks alone, on one seeded
            # input, at batch 1 and 5 against 16: each row computed alone
            visual = clf._clip_params["visual"]
            ccfg = clf.clip_cfg
            tokens = (ccfg.image_resolution // ccfg.vision_patch_size) ** 2 + 1
            h = torch.randn(TOOLKIT_MAX_BATCH, tokens, ccfg.vision_width, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(SEED))
            h = h.to(torch.bfloat16)
            stack = [transformer(h[:n], visual["blocks"], ccfg.vision_heads,
                                 qblocks=visual.get("blocks_q")) for n in (1, 5, 16)]
            full_f = clf._encode(x)
            full_p = clf.model.probs(full_f, clf.cfg.alpha, clf.cfg.beta)
            pad = {}
            for n in (1, 5, 8):  # buckets 1, 8 (padded) and 8
                bucket = next(b for b in clf.batch_buckets if b >= n)
                rows = torch.zeros_like(x[:bucket])
                rows[:n] = x[:n]
                f = clf._encode(rows)[:n]
                pad[str(n)] = {"bucket": bucket,
                               "feature_cos_min": float(row_cosines(torch, f, full_f[:n]).min()),
                               **bars_agreement(clf.model.probs(f, clf.cfg.alpha, clf.cfg.beta),
                                                full_p[:n], bucket_bars)}
        cos = row_cosines(torch, feats.cpu(), cpu_feats)
        p, i = clf.infer_canvases(batch)
        _, full_i = clf.infer_canvases(canvases)
        for n in (1, 5, 8):
            pad[str(n)]["topk_ids_equal"] = bool(np.array_equal(clf.infer_canvases(
                canvases[:n])[1], full_i[:n]))
        model = clf.model
        clf.model = dataclasses.replace(model, bank_t=torch.roll(model.bank_t, 1, dims=0))
        swapped_p, swapped_i = clf.infer_canvases(batch)
        clf.model = model
        held = {
            "feature_cos_vs_cpu_fp32": cos.tolist(),
            "topk_cpu_on_card_features_max_abs_diff": float((card_p.cpu() - cpu_p).abs().max()),
            "topk_ids_equal": bool(torch.equal(card_i.cpu(), cpu_i)),
            "infer_vs_halves_max_abs_diff": float(np.abs(p - card_p.cpu().numpy()).max()),
            "block_stack_rows_bit_identical_at_1_5_16": bool(
                torch.equal(stack[0], stack[2][:1]) and torch.equal(stack[1], stack[2][:5])),
            "block_stack_rows_max_abs_diff": float(max(
                (stack[0] - stack[2][:1]).abs().max(), (stack[1] - stack[2][:5]).abs().max())),
            "bucket_rows_vs_full_batch": pad,
            "model_swap_changed_output": bool(not np.array_equal(swapped_i, i)
                                              or not np.allclose(swapped_p, p)),
        }
        check(float(cos.min()) >= bar, f"card vs CPU fp32 feature cosine {cos.tolist()} < {bar}")
        check(held["topk_ids_equal"] and held["topk_cpu_on_card_features_max_abs_diff"] <= 1e-5,
              "the CPU's top-k on the card's features differ from the card's")
        check(np.array_equal(i, card_i.cpu().numpy()) and held["infer_vs_halves_max_abs_diff"]
              <= 1e-6, "infer_canvases differs from its two halves on the same batch")
        check(held["block_stack_rows_bit_identical_at_1_5_16"],
              "the fused-block stack's rows depend on the batch")
        check(all(v["feature_cos_min"] >= bucket_bars[1] and v["ok"] for v in pad.values()),
              f"padded buckets off the full batch: {pad}")
        check(held["model_swap_changed_output"], "swapping clf.model changed nothing")
        return held

    clf, load_s = classifier(cfg)
    crops, counts, robot = robot_path(clf, "bf16")
    px = clf.clip_cfg.image_resolution
    canvases = np.concatenate([clf._preprocess_crops(crops),
                               np.random.default_rng(SEED).integers(
                                   0, 256, (TOOLKIT_MAX_BATCH - len(crops), px, px, 3),
                                   dtype=np.uint8)])
    cpu, cpu_load_s = classifier(dataclasses.replace(cfg, compute_dtype="float32"), "cpu")
    t0 = time.perf_counter()
    cpu_feats = cpu._encode(torch.from_numpy(canvases[:8]))  # outside the int8 mode
    cpu_encode_s = time.perf_counter() - t0
    held = held_against_cpu(clf, cpu, cpu_feats, canvases, 0.999, BARS["bfloat16"])
    # an fp32 tower on the card beside the bf16 one (K2's fp32 kernels)
    with torch.inference_mode():
        card32 = to_device({"visual": cpu._clip_params["visual"]}, torch.device("cuda"))
        f32 = encode_image(card32, normalize_batch(torch.from_numpy(canvases[:8]).cuda()),
                           cpu.clip_cfg)
        f32 = l2_normalize(f32.float()).cpu()
    held["fp32_tower_cos_vs_cpu"] = row_cosines(torch, f32, cpu_feats).tolist()
    held["fp32_tower_rel_err"] = float((f32 - cpu_feats).abs().max() / cpu_feats.abs().max())
    del card32, f32
    times = classify_times(torch, np, clf, canvases, "fused_transformer_block")
    require(counts["fused_transformer_block"] == clf.clip_cfg.vision_layers
            and counts["fused_transformer_block_int8"] == 0,
            f"the robot path's classify call launched {counts}")

    with int8_mode():
        clf8, load8_s = classifier(cfg)
        crops8, counts8, robot8 = robot_path(clf8, "int8")
        held8 = held_against_cpu(clf8, cpu, cpu_feats, canvases, 0.995,
                                 INT8_BLOCK_BARS["bfloat16"])
        times8 = classify_times(torch, np, clf8, canvases, "fused_transformer_block_int8")
    require(counts8["fused_transformer_block_int8"] == clf8.clip_cfg.vision_layers
            and counts8["fused_transformer_block"] == 0,
            f"the int8 robot path's classify call launched {counts8}")
    del cpu

    # OOD: an imagenet_v2-layout tree of class-coloured JPEGs through
    # make_encode_fns, then from its cache: with the FewSOL triple, and with a
    # triple fitted to the cached features (its first OOD_CLASSES classes'
    # banks are those classes' features, no adapter), whose accuracy is not 0
    ood_root = os.path.join(root, "imagenet_v2")
    np_rng = np.random.default_rng(SEED)
    colours = np_rng.integers(0, 200, (OOD_CLASSES, 3))
    for c in range(OOD_CLASSES):
        os.makedirs(os.path.join(ood_root, str(c)))
        for k in range(OOD_PER_CLASS):
            pixels = colours[c] + np_rng.integers(0, 56, (240, 320, 3))
            Image.fromarray(pixels.astype(np.uint8)).save(
                os.path.join(ood_root, str(c), f"{k}.jpeg"), quality=90)
    with open(os.path.join(ood_root, "0", ".DS_Store"), "wb") as fh:
        fh.write(b"\x00\x01junk")
    with open(os.path.join(ood_root, "1", "README.txt"), "w") as fh:
        fh.write("not an image\n")
    t0 = time.perf_counter()
    encode_fn, _, clip_cfg, _ = make_encode_fns(cfg)
    ood_load_s = time.perf_counter() - t0
    cache = FeatureCache(cfg.cache_dir, cfg.backbone, cfg.shots)
    stems = cache.split_stems("ood_imagenet_v2")
    triples = {"fewsol": paths, "fitted": [os.path.join(root, f"fitted_{s}.pt") for s in "vta"]}
    ood = {}
    for run, triple in (("encoded", "fewsol"), ("cached", "fewsol"), ("cached_fitted", "fitted")):
        if triple == "fitted":
            feats = cache.load(stems[0])["features"]
            labels = cache.load(stems[1])["labels"]
            bank_v = unit_rows(np, np_rng, TOOLKIT_N_CLASS * cfg.shots, clip_cfg.embed_dim)
            bank_t = unit_rows(np, np_rng, TOOLKIT_N_CLASS, clip_cfg.embed_dim)
            for c in range(OOD_CLASSES):
                own = feats[labels == c]
                bank_v[c * cfg.shots:(c + 1) * cfg.shots] = np.resize(own, (cfg.shots, own.shape[1]))
                bank_t[c] = own.mean(axis=0)
            save_checkpoint_triple(*triples["fitted"], bank_v, bank_t, {})
        v, t, a = triples[triple]
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        acc = test_ood_performance(cfg, "imagenet_v2", encode_fn, ood_root, cache=cache,
                                   memory_bank_v_path=v, memory_bank_t_path=t,
                                   adapter_weights_path=a, image_size=clip_cfg.image_resolution)
        torch.cuda.synchronize()
        ood[run] = {"triple": triple, "accuracy": acc, "s": time.perf_counter() - t0,
                    "launches": {k: n for k, n in K.launch_counts().items() if n}}
        # the same accuracy on the CPU from the card's (cached) features
        bank_v, bank_t, state = load_checkpoint_triple(v, t, a)
        cpu_model = from_arrays(bank_v, bank_t,
                                adapter_from_torch_state(state, cfg.adapter) if state else {},
                                cfg.adapter, cfg.shots, device="cpu")
        feats = cache.load(stems[0])["features"]
        labels = cache.load(stems[1])["labels"]
        ood[run]["cpu_accuracy_on_card_features"] = accuracy(
            cpu_model, feats, labels, cfg.alpha, cfg.beta) * 100.0
    n_ood = OOD_CLASSES * OOD_PER_CLASS
    batches = -(-n_ood // cfg.batch_size)
    require(feats.shape == (n_ood, clip_cfg.embed_dim) and np.isfinite(feats).all()
            and sorted(set(labels.tolist())) == list(range(OOD_CLASSES)),
            f"OOD features {feats.shape}, labels {sorted(set(labels.tolist()))}")
    require(ood["encoded"]["launches"].get("fused_transformer_block")
            == clip_cfg.vision_layers * batches,
            f"the OOD run launched {ood['encoded']['launches']}")
    require(not ood["cached"]["launches"] and not ood["cached_fitted"]["launches"],
            f"a cached OOD run launched kernels: {ood}")
    require(ood["encoded"]["accuracy"] == ood["cached"]["accuracy"]
            and all(o["accuracy"] == o["cpu_accuracy_on_card_features"] for o in ood.values()),
            f"OOD accuracies {ood}: the card's and the CPU's differ")

    emit({"phase": "toolkit", "config": TOOLKIT_CONFIG, "backbone": cfg.backbone,
          "dtype": "bfloat16", "weights": "random, seed 0", "n_class": TOOLKIT_N_CLASS,
          "shots": cfg.shots, "adapter": cfg.adapter, "alpha": cfg.alpha, "beta": cfg.beta,
          "top_k": cfg.top_k, "max_batch": TOOLKIT_MAX_BATCH, "buckets": list(TOOLKIT_BUCKETS),
          "frame": list(FRAME_HW), "load_s": {"bf16": load_s, "int8": load8_s,
                                               "cpu_fp32": cpu_load_s, "ood": ood_load_s},
          "cpu_fp32_encode_8_s": cpu_encode_s,
          "robot": robot, "held": held, "classify_times": times,
          "int8": {"robot": robot8, "held": held8, "classify_times": times8},
          "ood": {**ood, "images": n_ood, "classes": OOD_CLASSES},
          "failures": failures, "seconds": time.perf_counter() - t_phase})
    require(not failures, f"toolkit checks failed: {failures}")
    return counts, counts8, clf._clip_params, clf8._clip_params, clf


# -- 10. serve ------------------------------------------------------------------------

SERVE_BACKBONE = "ViT-B/16"
SERVE_BATCH, SERVE_BUCKETS = 256, (8, 64)
SERVE_CONCURRENCY = (1, 8, 32)
# each route and concurrency: a window of at least SERVE_WINDOW_S seconds and
# SERVE_MIN_SAMPLES requests ended in it, after SERVE_WARMUP_S of traffic
SERVE_WARMUP_S, SERVE_WINDOW_S, SERVE_MAX_WINDOW_S = 0.5, 4.0, 20.0
SERVE_MIN_SAMPLES = 200
SERVE_LOADGEN_TIMEOUT_S = 300
SERVE_JPEGS = 24  # distinct 480 x 640 JPEGs the requests draw from
SERVE_CPU_IMAGES = 8
# the JAX bundle bars (commit aa2a6a6): bucket rows against the full batch's
SERVE_BUCKET_BARS = {"bf16": (1e-5, None), "int8": (1e-2, 0.9995)}
SERVE_CPU_COSINE = {"bf16": 0.999, "int8": 0.995}
SERVE_CLI_TIMEOUT_S = 240


def serve_jpegs(np):
    """SERVE_JPEGS seeded synthetic camera frames (480 x 640, a colour field
    with noise and a few boxes), JPEG-encoded at quality 90."""
    import io

    from PIL import Image

    np_rng = np.random.default_rng(SEED)
    h, w = FRAME_HW
    out = []
    for _ in range(SERVE_JPEGS):
        pixels = np_rng.integers(0, 200, 3) + np_rng.integers(0, 56, (h, w, 3))
        for _ in range(3):
            top, left = np_rng.integers(0, h - 120), np_rng.integers(0, w - 160)
            pixels[top:top + 120, left:left + 160] = np_rng.integers(0, 256, 3)
        buf = io.BytesIO()
        Image.fromarray(pixels.astype(np.uint8)).save(buf, "JPEG", quality=90)
        out.append(buf.getvalue())
    return out


def bucket_times(torch, np, enc, eager, images):
    """Each bucket of a loaded bundle against the eager encode of the same
    bucket: CUDA-event ms and device ms (:func:`device_ms`) of one replay
    and of one eager call on the bucket's input buffer, the host's time to
    issue each, and the host wall ms of one whole bundle call (rows up,
    replay, rows back) against the same done eagerly."""
    out = {}
    for size, art in sorted(enc.artifacts.items()):
        block = images[:size]
        enc(block)
        replay = art.graph.replay

        def eager_call():
            return eager(enc.params, art.input)

        def eager_whole():
            return eager(enc.params, torch.from_numpy(block).cuda()).cpu().numpy()

        def issue(fn):
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                walls.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            return sorted(walls)[2]

        def wall(fn):
            fn()
            walls = []
            for _ in range(TIME_RUNS):
                t0 = time.perf_counter()
                fn()
                walls.append((time.perf_counter() - t0) * 1e3)
            return sorted(walls)[len(walls) // 2]

        row = {"replay_ms": median_ms(torch, replay), "replay_device_ms": device_ms(torch, replay),
               "replay_issue_ms": issue(replay),
               "eager_ms": median_ms(torch, eager_call),
               "eager_device_ms": device_ms(torch, eager_call),
               "eager_issue_ms": issue(eager_call),
               "call_wall_ms": wall(lambda: enc(block)), "eager_call_wall_ms": wall(eager_whole)}
        row["images_per_s"] = size / row["call_wall_ms"] * 1e3
        row["eager_images_per_s"] = size / row["eager_call_wall_ms"] * 1e3
        out[str(size)] = row
    return out


def hold_bundle(torch, np, enc, mode, images, cpu_ref):
    """A loaded bundle's buckets: every bucket a CUDA graph with the block
    launched once a layer per replay; each replay against the eager encode
    of the same bucket (bit for bit, bar 1e-5); each bucket's rows, full
    and padded, against the largest bucket's (SERVE_BUCKET_BARS); the
    features of SERVE_CPU_IMAGES images against the fp32 CPU encode."""
    from protoclip_tpu_torch.io import make_encode_fn

    layers = enc.cfg.vision_layers
    block = "fused_transformer_block_int8" if mode == "int8" else "fused_transformer_block"
    eager = make_encode_fn(enc.cfg, normalize=True, int8=mode == "int8")

    full = enc(images)
    held = {"per_replay": {}, "warmup": {}, "replay_vs_eager_max_abs_diff": {},
            "bucket_vs_full": {}}
    for size, art in sorted(enc.artifacts.items()):
        require(art.graph is not None, f"{mode} bucket {size} is not a CUDA graph")
        held["per_replay"][str(size)] = art.launches_per_replay
        held["warmup"][str(size)] = art.warmup_launches
        require(art.launches_per_replay.get(block) == layers
                and not any(k.startswith("fused_transformer_block") and k != block
                            for k in art.launches_per_replay),
                f"{mode} bucket {size} captured {art.launches_per_replay}, expected {block} "
                f"x {layers}")
        replayed = art(images[:size])
        eager_out = eager(enc.params, art.input).cpu().numpy()
        diff = float(np.abs(replayed - eager_out).max())
        held["replay_vs_eager_max_abs_diff"][str(size)] = diff
        held.setdefault("replay_bit_identical", {})[str(size)] = bool(
            np.array_equal(replayed, eager_out))
        require(diff <= 1e-5, f"{mode} bucket {size}: replay vs eager {diff} > 1e-5")
        for n in (size, size - 3):
            rows = enc(images[:n])
            bar, min_cos = SERVE_BUCKET_BARS[mode]
            d = float(np.abs(rows - full[:n]).max())
            cos = float((torch.nn.functional.cosine_similarity(
                torch.from_numpy(rows), torch.from_numpy(full[:n]), dim=-1)).min())
            held["bucket_vs_full"][str(n)] = {"bucket": size, "max_abs_diff": d,
                                              "row_cos_min": cos,
                                              "bit_identical": bool(np.array_equal(rows, full[:n]))}
            require(d <= bar and (min_cos is None or cos >= min_cos),
                    f"{mode}: {n} rows in bucket {size} off the full batch: {d}, cos {cos}")
    cos = row_cosines(torch, torch.from_numpy(full[:SERVE_CPU_IMAGES]), cpu_ref)
    held["cos_vs_cpu_fp32"] = cos.tolist()
    require(float(cos.min()) >= SERVE_CPU_COSINE[mode],
            f"{mode} bundle vs the fp32 CPU encode: cosine {cos.tolist()}")
    return held, eager


def _proc_cpu_s(pid):
    """User + system CPU seconds of process ``pid`` so far (Linux /proc)."""
    with open(f"/proc/{pid}/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def loadgen_cell(np, url, route, jpegs, concurrency, server_pid):
    """One route at one concurrency: ``concurrency`` client threads, each a
    ``ServeClient`` sending requests of 1-4 of the seeded JPEGs back to back
    until told to stop.  After SERVE_WARMUP_S a window opens; it closes once
    it has lasted SERVE_WINDOW_S and SERVE_MIN_SAMPLES requests ended inside
    it (at most SERVE_MAX_WINDOW_S).  Over the requests that ended in the
    window: requests/s, images/s, p50/p99 latency, and the client's own share
    of each request (base64 + ``json.dumps`` of the body; ``json.loads`` of
    the answer and its array) apart from the rest (the wire and the server);
    the server's dispatches and fill from ``/statz`` at the window's ends;
    the CPU cores the server process and this one used in the window."""
    import threading
    import urllib.request

    from protoclip_tpu_torch.client import ServeClient, _to_b64

    class TimedClient(ServeClient):
        """``ServeClient._post`` with the client's own work timed apart."""

        def _post(self, path, images):
            t0 = time.perf_counter()
            body = json.dumps({"images": [_to_b64(im) for im in images]}).encode()
            t1 = time.perf_counter()
            req = urllib.request.Request(self.base_url + path, data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                raw = resp.read()
            t2 = time.perf_counter()
            out = json.loads(raw)
            self.last = (t1 - t0, time.perf_counter() - t2)
            return out

    done, errors, lock, stop = [], [], threading.Lock(), threading.Event()

    def worker(k):
        np_rng = np.random.default_rng([SEED, concurrency, k])
        client = TimedClient(url, timeout=120.0)
        call = client.encode if route == "/encode" else client.classify
        while not stop.is_set():
            req = [jpegs[i] for i in np_rng.choice(len(jpegs), int(np_rng.integers(1, 5)))]
            t0 = time.perf_counter()
            try:
                call(req)
            except Exception as exc:  # noqa: BLE001 - counted and raised by the caller
                with lock:
                    errors.append(f"{type(exc).__name__}: {exc}")
                continue
            t1 = time.perf_counter()
            with lock:
                done.append((t0, t1, len(req), *client.last))
            client.last = (0.0, 0.0)

    statz = ServeClient(url, timeout=60.0)
    threads = [threading.Thread(target=worker, args=(k,), daemon=True)
               for k in range(concurrency)]
    for t in threads:
        t.start()
    time.sleep(SERVE_WARMUP_S)
    before = statz.statz()[route]
    cpu0 = (_proc_cpu_s(server_pid), sum(os.times()[:2]))
    t_open = time.perf_counter()
    while True:
        time.sleep(0.05)
        now = time.perf_counter()
        with lock:
            n = sum(1 for r in done if r[1] >= t_open)
        if (now - t_open >= SERVE_WINDOW_S and n >= SERVE_MIN_SAMPLES) \
                or now - t_open >= SERVE_MAX_WINDOW_S or errors:
            break
    t_close = time.perf_counter()
    cpu1 = (_proc_cpu_s(server_pid), sum(os.times()[:2]))
    after = statz.statz()[route]
    stop.set()
    for t in threads:
        t.join(timeout=120)
    window = t_close - t_open
    rows = [r for r in done if t_open <= r[1] <= t_close]
    lat = sorted((r[1] - r[0]) * 1e3 for r in rows)
    enc = sorted(r[3] * 1e3 for r in rows)
    dec = sorted(r[4] * 1e3 for r in rows)
    rest = sorted((r[1] - r[0] - r[3] - r[4]) * 1e3 for r in rows)

    def q(v, p):
        return v[min(len(v) - 1, int(len(v) * p))] if v else None

    dispatches = after["dispatches"] - before["dispatches"]
    return {"samples": len(rows), "window_s": window, "errors": errors[:3],
            "stuck_clients": sum(t.is_alive() for t in threads),
            "images": sum(r[2] for r in rows),
            "requests_per_s": len(rows) / window, "images_per_s": sum(r[2] for r in rows) / window,
            "p50_ms": q(lat, 0.5), "p99_ms": q(lat, 0.99),
            "client_encode_ms_p50": q(enc, 0.5), "client_decode_ms_p50": q(dec, 0.5),
            "wire_and_server_ms_p50": q(rest, 0.5), "wire_and_server_ms_p99": q(rest, 0.99),
            "dispatches": dispatches,
            "mean_fill": (after["images"] - before["images"]) / max(dispatches, 1),
            "dispatches_per_s": dispatches / window,
            "dispatch_ms_p50": after.get("dispatch_ms_p50"),
            "dispatch_ms_p99": after.get("dispatch_ms_p99"),
            "server_cpu_cores": (cpu1[0] - cpu0[0]) / window,
            "loadgen_cpu_cores": (cpu1[1] - cpu0[1]) / window}


def loadgen_main(argv) -> int:
    """``chip_smoke.py --loadgen URL SERVER_PID``: the serve phase's clients,
    in a process of their own so that they share no interpreter lock with
    the server.  Drives every route at every concurrency of
    SERVE_CONCURRENCY (:func:`loadgen_cell`) and prints one JSON object."""
    import numpy as np

    url, server_pid = argv[0], int(argv[1])
    jpegs = serve_jpegs(np)
    out = {f"{route}@{conc}": loadgen_cell(np, url, route, jpegs, conc, server_pid)
           for route in ("/encode", "/classify") for conc in SERVE_CONCURRENCY}
    print(json.dumps(out), flush=True)
    return 0


def phase_serve(torch, np, tmp, clf):
    """Serving through its entry points, on the card at full width (random
    weights, seed 0): ViT-B/16 bundles written by ``cli.export.main``
    (batch 256, buckets 8 and 64) in bf16 and W8A8, loaded with one CUDA
    graph per bucket and held (:func:`hold_bundle`) and timed against the
    eager encode (:func:`bucket_times`); then ``cli.serve.build_server``
    over the bf16 bundle and the ``toolkit`` phase's ViT-L/14 FewSOL-198
    classifier, driven by ``client.ServeClient`` threads in a process of
    their own (:func:`loadgen_main`) at concurrency 1, 8 and 32 with seeded
    480 x 640 JPEGs (1-4 a request); decode + preprocess ms, native and
    PIL, and the JSON encode ms; the served answers held against direct
    calls; the protocol's errors; and the serve CLI in a subprocess
    (``/healthz``, one ``/encode``, SIGTERM).

    Returns (the launch counts of the server's start, of its traffic, and
    {"per_replay": each bundle's launches per replay by bucket,
    "per_classify_call": the traffic's launches per /classify dispatch})."""
    import base64
    import io
    import re
    import signal
    import socket
    import threading

    from PIL import Image

    from protoclip_tpu_torch import native
    from protoclip_tpu_torch.cli.export import main as export_main
    from protoclip_tpu_torch.cli.serve import _preprocess_block, build_server
    from protoclip_tpu_torch.client import ServeClient, ServeError
    from protoclip_tpu_torch.data import clip_preprocess, normalize_batch
    from protoclip_tpu_torch.io import load_serving_bundle
    from protoclip_tpu_torch.models.clip import cast_params, encode_image, to_device
    from protoclip_tpu_torch.ops import kernels as K
    from protoclip_tpu_torch.ops.proto import l2_normalize

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "serve")
    preprocess_path = "native" if native.load() is not None else "PIL"
    n_px = 224
    images = np.random.default_rng(SEED).integers(0, 256, (SERVE_BATCH, n_px, n_px, 3),
                                                  dtype=np.uint8)
    dirs, export_s, load_s, encs = {}, {}, {}, {}
    for mode in ("bf16", "int8"):
        dirs[mode] = os.path.join(root, f"vit_b16_{mode}")
        t0 = time.perf_counter()
        export_main(["--backbone", SERVE_BACKBONE, "--out", dirs[mode], "--batch",
                     str(SERVE_BATCH), "--buckets", *map(str, SERVE_BUCKETS)]
                    + (["--int8"] if mode == "int8" else []))
        export_s[mode] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        encs[mode] = load_serving_bundle(dirs[mode])
        torch.cuda.synchronize()
        load_s[mode] = time.perf_counter() - t0
    bundle_mb = sum(os.path.getsize(os.path.join(dirs["bf16"], f))
                    for f in os.listdir(dirs["bf16"])) / 2**20

    # one fp32 CPU reference: both exports drew the same weights from seed 0
    vis = {m: [t for t in tensors(e.params["visual"]["blocks"])] for m, e in encs.items()}
    require(all(torch.equal(a, b) for a, b in zip(vis["bf16"], vis["int8"])),
            "the bf16 and int8 bundles hold different weights")
    del vis
    cfg = encs["bf16"].cfg
    t0 = time.perf_counter()
    with torch.inference_mode():
        cpu32 = cast_params(to_device({"visual": encs["bf16"].params["visual"]},
                                      torch.device("cpu")), torch.float32)
        x = torch.from_numpy(images[:SERVE_CPU_IMAGES])
        cpu_ref = l2_normalize(encode_image(cpu32, normalize_batch(x, torch.float32),
                                            cfg).float())
    cpu_s = time.perf_counter() - t0
    del cpu32
    held, times = {}, {}
    for mode, enc in encs.items():
        held[mode], eager = hold_bundle(torch, np, enc, mode, images, cpu_ref)
        times[mode] = bucket_times(torch, np, enc, eager, images)
    per_replay = {mode: {size: art.launches_per_replay for size, art in enc.artifacts.items()}
                  for mode, enc in encs.items()}
    del encs
    torch.cuda.empty_cache()

    # the server in this process: /encode over the bf16 bundle, /classify
    # over the toolkit phase's classifier
    jpegs = serve_jpegs(np)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    srv = build_server(port=0, bundle=dirs["bf16"], classifier=clf, quiet=True)
    torch.cuda.synchronize()
    start_s = time.perf_counter() - t0
    start_counts = K.launch_counts()
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    client = ServeClient(url, timeout=120.0)
    routes = srv.RequestHandlerClass.routes
    encode_route = routes["/encode"]
    failures = []

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    try:
        # the clients in a process of their own (loadgen_main)
        K.reset_launch_counts()
        before = client.statz()["/classify"]["dispatches"]
        t0 = time.perf_counter()
        gen = subprocess.run([sys.executable, os.path.abspath(__file__), "--loadgen", url,
                              str(os.getpid())], capture_output=True, text=True,
                             timeout=SERVE_LOADGEN_TIMEOUT_S)
        traffic_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        traffic_counts = K.launch_counts()
        classify_dispatches = client.statz()["/classify"]["dispatches"] - before
        require(gen.returncode == 0, f"the load generator exited {gen.returncode}: "
                                     f"{gen.stderr[-2000:]}")
        traffic = json.loads(gen.stdout.strip().splitlines()[-1])
        for cell, row in traffic.items():
            check(not row["errors"] and not row["stuck_clients"]
                  and row["samples"] >= SERVE_MIN_SAMPLES,
                  f"{cell}: {row['samples']} requests in the window, errors {row['errors']}, "
                  f"{row['stuck_clients']} clients stuck")
        layers_l = clf.clip_cfg.vision_layers
        check(traffic_counts["fused_transformer_block"] == layers_l * classify_dispatches,
              f"serving launched {traffic_counts['fused_transformer_block']} K2 blocks for "
              f"{classify_dispatches} classify dispatches of {layers_l} layers "
              f"(the /encode replays launch none of their own)")

        # host work apart from the dispatch: decode + preprocess, JSON
        def b64(req):
            return {"images": [base64.b64encode(j).decode() for j in req]}

        # decode + preprocess an image, on the route's pool (a request of 4)
        # and on one thread, through the native resize and through PIL in
        # turns on the same JPEGs
        payload = b64(jpegs[:4])
        pre = {"native": ([], []), "PIL": ([], [])}
        blocks = {}
        try:
            for _ in range(3):
                for path, gate in (("native", "1"), ("PIL", "0")):
                    os.environ["PROTOCLIP_NATIVE"] = gate
                    pool_ms, one_ms = pre[path]
                    for _ in range(3):
                        t0 = time.perf_counter()
                        blocks[path] = _preprocess_block(payload, n_px, encode_route.pool, False)
                        pool_ms.append((time.perf_counter() - t0) * 1e3 / 4)
                    for j in jpegs[:8]:
                        t0 = time.perf_counter()
                        clip_preprocess(Image.open(io.BytesIO(j)).convert("RGB"), n_px)
                        one_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            os.environ["PROTOCLIP_NATIVE"] = "1"
        check(np.array_equal(blocks["native"], blocks["PIL"]),
              "the native preprocess differs from PIL's on the serve JPEGs")
        block = blocks["native"]
        json_ms = {}
        for n in (4, SERVE_BATCH):
            feats = encode_route.encode(images[:n])
            tl, dump = [], []
            for _ in range(5):
                t0 = time.perf_counter()
                listed = feats.tolist()
                t1 = time.perf_counter()
                json.dumps({"features": listed}).encode()
                tl.append((t1 - t0) * 1e3)
                dump.append((time.perf_counter() - t1) * 1e3)
            json_ms[str(n)] = {"tolist_ms": sorted(tl)[2], "dumps_ms": sorted(dump)[2]}
        host = {"preprocess_path": preprocess_path, "encode_json_ms": json_ms}
        for path, (pool_ms, one_ms) in pre.items():
            host[f"decode_preprocess_ms_per_image_pool_{path}"] = sorted(pool_ms)[len(pool_ms) // 2]
            host[f"decode_preprocess_ms_per_image_one_thread_{path}"] = \
                sorted(one_ms)[len(one_ms) // 2]

        # the served answers against direct calls on the server's own
        # preprocess of the same bytes
        served = client.encode(jpegs[:4])
        direct = encode_route.encode(block)
        check(np.array_equal(served, direct), "a lone /encode request's rows differ from the "
                                              "direct bundle call")
        # 16 concurrent requests, coalesced: each must get exactly the rows
        # a direct call of its own block gives
        reqs = [[jpegs[(3 * i + k) % len(jpegs)] for k in range(1 + i % 4)] for i in range(16)]
        outs = [None] * len(reqs)

        def post(i):
            outs[i] = ServeClient(url, timeout=120.0).encode(reqs[i])

        before = client.statz()["/encode"]
        threads = [threading.Thread(target=post, args=(i,), daemon=True) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        after = client.statz()["/encode"]
        coalesced = {"requests": len(reqs), "rows": sum(map(len, reqs)),
                     "dispatches": after["dispatches"] - before["dispatches"]}
        coalesced["differ"] = sum(
            not np.array_equal(out, encode_route.encode(
                _preprocess_block(b64(req), n_px, encode_route.pool, False)))
            for req, out in zip(reqs, outs))
        check(coalesced["differ"] == 0, f"coalesced /encode requests differ from direct calls: "
                                        f"{coalesced}")
        crops = [np.asarray(Image.open(io.BytesIO(j)).convert("RGB")) for j in jpegs[4:8]]
        names, probs = client.classify(jpegs[4:8])
        want_names, want_probs = clf.classify_objects(crops)
        classify_diff = float(np.abs(probs - want_probs).max())
        check(names == want_names and classify_diff <= 1e-6,
              f"/classify differs from classify_objects: {classify_diff}")
        health = client.healthz()
        statz = client.statz()
        metrics = client.metrics()
        sample = re.compile(r'^[a-z_]+(\{[a-z]+="[^"]*"(,[a-z]+="[^"]*")*\})? [-0-9.e+]+$')
        check(health["status"] == "ok" and set(statz) == {"/encode", "/classify"}
              and all(sample.match(line) for line in metrics.strip().split("\n")
                      if not line.startswith("#")), "healthz/statz/metrics do not parse")
        codes = {}
        for name, call in (("bad_payload", lambda: client.encode([b"junk"])),
                           ("unknown_route", lambda: client._post("/nope", jpegs[:1]))):
            try:
                call()
                codes[name] = 200
            except ServeError as err:
                codes[name] = err.status
        check(codes == {"bad_payload": 400, "unknown_route": 404}, f"error codes {codes}")
        served_checks = {"lone_encode_bit_identical": bool(np.array_equal(served, direct)),
                         "coalesced": coalesced,
                         "classify_names_equal": names == want_names,
                         "classify_max_abs_diff": classify_diff, "error_codes": codes,
                         "healthz": health["status"]}
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)

    # the serve CLI in a subprocess: /healthz, one /encode, exit 0 on SIGTERM
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "protoclip_tpu_torch.cli.serve", "--bundle",
                             dirs["bf16"], "--port", str(port)], stderr=subprocess.PIPE,
                            text=True)
    cli = {}
    try:
        cli_client = ServeClient(f"http://127.0.0.1:{port}", timeout=60.0)
        deadline = time.monotonic() + SERVE_CLI_TIMEOUT_S
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                cli["healthz"] = cli_client.healthz()["status"]
                break
            except OSError:
                time.sleep(0.5)
        cli["ready_s"] = time.perf_counter() - t0
        cli["encode_rows"] = len(cli_client.encode(jpegs[:2])) if "healthz" in cli else 0
        proc.send_signal(signal.SIGTERM)
        cli["exit_code"] = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    stderr_tail = proc.stderr.read()[-2000:]
    check(cli.get("healthz") == "ok" and cli.get("encode_rows") == 2
          and cli.get("exit_code") == 0, f"the serve CLI: {cli}; stderr: {stderr_tail}")

    emit({"phase": "serve", "backbone": SERVE_BACKBONE, "weights": "random, seed 0",
          "batch": SERVE_BATCH, "buckets": sorted({*SERVE_BUCKETS, SERVE_BATCH}),
          "bundle_mb": bundle_mb, "export_s": export_s, "load_s": load_s, "cpu_fp32_s": cpu_s,
          "held": held, "bucket_times": times, "server_start_s": start_s,
          "server_start_launches": {k: v for k, v in start_counts.items() if v},
          "traffic": traffic, "traffic_s": traffic_s, "traffic_launches": {k: v for k, v in traffic_counts.items() if v},
          "classify_backbone": clf.clip_cfg.name, "classify_buckets": clf.batch_buckets,
          "host": host, "served": served_checks, "cli": cli, "failures": failures,
          "seconds": time.perf_counter() - t_phase})
    require(not failures, f"serve checks failed: {failures}")
    per_call = {k: v / max(classify_dispatches, 1) for k, v in traffic_counts.items() if v}
    return start_counts, traffic_counts, {"per_replay": per_replay, "per_classify_call": per_call}


def tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors(v)
    else:
        yield tree


# -- 11. the data mesh on one card -------------------------------------------------------

MESH_BACKBONE = "ViT-B/16"
MESH_BATCH = 256
MESH_QT_BATCH = 64
MESH_COSINE = 0.99999
MESH_SERVE_BATCH = 32  # per device
MESH_RANKS = 2
MESH_RANK_TIMEOUT_S = 240


def mesh_config():
    """The runner's config for the mesh phase: ViT-B/16, random weights
    (seed 0), bf16."""
    from protoclip_tpu_torch.core import Config

    return Config(dataset="caltech101", backbone=MESH_BACKBONE, compute_dtype="bfloat16")


def mesh_images(np):
    """The phase's global batch: MESH_BATCH seeded uint8 224 x 224 images."""
    return np.random.default_rng(SEED + 11).integers(0, 256, (MESH_BATCH, 224, 224, 3),
                                                     dtype=np.uint8)


def mesh_qt_trainer(np, clip_cfg, params, mesh=None, device=None):
    """A Q^T trainer over ViT-B/16 (10 classes x 4 shots, fc adapter), the
    same initial state on every process."""
    from protoclip_tpu_torch.train import QTTrainer

    np_rng = np.random.default_rng(SEED + 12)
    d = clip_cfg.embed_dim
    return QTTrainer(clip_params=params, clip_cfg=clip_cfg,
                     bank_v_init=np_rng.standard_normal((N_CLASS * SHOTS, d)).astype(np.float32),
                     bank_t_init=np_rng.standard_normal((N_CLASS, d)).astype(np.float32),
                     n_class=N_CLASS, k_shots=SHOTS, adapter_kind="fc", alpha=0.5, beta=5.0,
                     lr=1e-3, train_epoch=2, seed=SEED, mesh=mesh, device=device)


def mesh_qt_batch(np):
    images = mesh_images(np)[:MESH_QT_BATCH]
    labels = np.random.default_rng(SEED + 13).integers(0, N_CLASS, MESH_QT_BATCH)
    return images, labels


def named_params(trainer):
    from protoclip_tpu_torch.train.episodic import named_leaves

    return {name: p.detach().float().cpu().numpy() for name, p in named_leaves(trainer.params)}


def mesh_rank_main(argv) -> int:
    """One rank of the mesh phase's two-process check (``chip_smoke.py
    --mesh-rank RANK WORLD RENDEZVOUS OUT``): joins the gloo group, encodes
    its shard of the global batch on ``cuda:0`` through the runner's mesh
    encode (the features gathered over the group), times the gather, runs
    one sharded Q^T step, and writes what it saw to ``OUT`` (``.npz``)."""
    import numpy as np
    import torch

    from protoclip_tpu_torch.ops import kernels as K
    from protoclip_tpu_torch.parallel import init_distributed, make_mesh
    from protoclip_tpu_torch.parallel.sharding import _all_gather_rows
    from protoclip_tpu_torch.train.runner import make_encode_fns

    rank, world, rendezvous, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    init_distributed(f"file://{rendezvous}", world, rank, backend="gloo")
    try:
        mesh = make_mesh(devices=["cuda:0"])
        encode, _, clip_cfg, params = make_encode_fns(mesh_config(), mesh=mesh)
        images = mesh_images(np)
        encode(images)  # warm-up
        torch.cuda.synchronize()
        K.reset_launch_counts()
        feats = encode(images)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        rows = MESH_BATCH // world
        local = feats[rank * rows:(rank + 1) * rows]
        gather_ms = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gathered = _all_gather_rows(local)
            torch.cuda.synchronize()
            gather_ms.append((time.perf_counter() - t0) * 1e3)
        trainer = mesh_qt_trainer(np, clip_cfg, params, mesh=mesh)
        qt_images, labels = mesh_qt_batch(np)
        stats = trainer.train_step(qt_images, labels, MESH_QT_BATCH)
        np.savez(out, features=feats.float().cpu().numpy(),
                 gathered_equal=np.asarray(torch.equal(gathered, feats)),
                 gather_ms=np.asarray(sorted(gather_ms)), loss=np.asarray(stats["loss"]),
                 k2=np.asarray(counts["fused_transformer_block"]),
                 **{f"param/{k}": v for k, v in named_params(trainer).items()})
    finally:
        torch.distributed.destroy_process_group()
    return 0


def run_mesh_ranks(np, tmp):
    """MESH_RANKS processes of this script sharing cuda:0 over gloo (NCCL
    refuses two ranks on one card), each joined with a hard timeout."""
    rendezvous = os.path.join(tmp, "mesh_rendezvous")
    outs = [os.path.join(tmp, f"mesh_rank{r}.npz") for r in range(MESH_RANKS)]
    logs = [open(os.path.join(tmp, f"mesh_rank{r}.log"), "w+") for r in range(MESH_RANKS)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
                               str(MESH_RANKS), rendezvous, outs[r]],
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(MESH_RANKS)]
    deadline = time.monotonic() + MESH_RANK_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        tails = []
        for log in logs:
            log.seek(0)
            tails.append(log.read()[-3000:])
            log.close()
    require(all(p.returncode == 0 for p in procs),
            f"mesh ranks exit codes {[p.returncode for p in procs]}: {tails}")
    results = []
    for out in outs:
        with np.load(out) as z:
            results.append({k: z[k] for k in z.files})
    return results


def phase_mesh(torch, np, tmp):
    """The data mesh through the runner, the Q^T trainer, the server and the
    extract CLI, on one card: (a) ``make_encode_fns(cfg, make_mesh(1))``
    encodes a B=256 batch in bf16 (K2) and W8A8 (K3), bit for bit the
    unsharded encode; (b) two 128-row shards on cuda:0 against the B=256
    encode; (c) one rank of NCCL and one sharded Q^T step (batch 64)
    against the unsharded step; (d) two processes of this script over gloo
    on cuda:0: the gathered features against the single-process encode and
    one Q^T step, the same parameters bit for bit on both ranks; (e) the
    serve CLI's mesh route (32 rows a device) and ``cli/extract.py
    --mesh 1``.  One card shows the wiring, not any scaling.  The launch
    counts are set to 0 before each mesh encode of (a) and read after."""
    from protoclip_tpu_torch.data import normalize_batch
    from protoclip_tpu_torch.models.clip import encode_image
    from protoclip_tpu_torch.ops import kernels as K
    from protoclip_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
        make_sharded_encode,
        replicated,
    )
    from protoclip_tpu_torch.parallel.sharding import _all_gather_rows
    from protoclip_tpu_torch.train.runner import make_encode_fns

    t_phase = time.perf_counter()
    images = mesh_images(np)
    one = make_mesh(1)
    two = make_mesh(devices=["cuda:0", "cuda:0"])
    counts: dict = {}
    report: dict = {}
    loaded = {}
    for mode in ("bf16", "int8"):
        with int8_mode() if mode == "int8" else contextlib.nullcontext():
            encode, _, clip_cfg, params = make_encode_fns(mesh_config(), mesh=one)
            loaded[mode] = params

            @torch.inference_mode()
            def image(p, x):
                return encode_image(p, normalize_batch(x, torch.bfloat16), clip_cfg)

            def unsharded():
                return image(params, torch.from_numpy(images).cuda())

            sharded_two = make_sharded_encode(image, two)
            replicas_two = replicated(two).put(params)
            ref = unsharded()
            encode(images)  # warm-up
            torch.cuda.synchronize()
            K.reset_launch_counts()
            got = encode(images)
            torch.cuda.synchronize()
            run_counts = K.launch_counts()
            for name, n in run_counts.items():
                counts[name] = counts.get(name, 0) + n
            block = "fused_transformer_block_int8" if mode == "int8" else "fused_transformer_block"
            other = "fused_transformer_block" if mode == "int8" else "fused_transformer_block_int8"
            require(run_counts[block] == clip_cfg.vision_layers and run_counts[other] == 0,
                    f"mesh encode ({mode}) launches {run_counts}")
            require(torch.equal(got, ref), f"mesh of 1 ({mode}) differs from the unsharded "
                    f"encode: {float((got.float() - ref.float()).abs().max())}")
            got_two = sharded_two(replicas_two, images)
            cos_two = float(row_cosines(torch, got_two.float(), ref.float()).min())
            err_two = float((got_two.float() - ref.float()).abs().max())
            require(cos_two >= MESH_COSINE, f"two shards on one card ({mode}): cosine "
                    f"{cos_two}, max abs {err_two}")
            ms = {"unsharded": median_ms(torch, unsharded),
                  "mesh_1": median_ms(torch, lambda: encode(images)),
                  "mesh_2_shards_one_card": median_ms(torch,
                                                      lambda: sharded_two(replicas_two, images))}
            report[mode] = {
                "mesh_1_bit_identical": True, "launches_mesh_1": run_counts[block],
                "two_shards_bit_identical": bool(torch.equal(got_two, ref)),
                "two_shards_min_cosine": cos_two, "two_shards_max_abs_err": err_two,
                "ms": ms, "images_per_s": {k: MESH_BATCH / (v / 1e3) for k, v in ms.items()},
            }
            if mode == "bf16":
                ref_bf16, cfg_vit = ref, clip_cfg
            del encode, sharded_two, replicas_two, got, got_two
    params = loaded.pop("bf16")
    loaded.clear()
    torch.cuda.empty_cache()

    # (c) one rank of NCCL: the sharded Q^T step against the unsharded one
    import socket

    saved = {k: os.environ.get(k) for k in ("PROTOCLIP_COORDINATOR", "PROTOCLIP_NUM_PROCESSES",
                                            "PROTOCLIP_PROCESS_ID")}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.environ.update(PROTOCLIP_COORDINATOR=f"127.0.0.1:{port}", PROTOCLIP_NUM_PROCESSES="1",
                      PROTOCLIP_PROCESS_ID="0")
    qt_images, labels = mesh_qt_batch(np)
    try:
        multi = init_distributed()
        backend = torch.distributed.get_backend()
        require(not multi and backend == "nccl", f"one NCCL rank: {multi}, {backend}")
        meshed = mesh_qt_trainer(np, cfg_vit, params, mesh=make_mesh())
        alone = mesh_qt_trainer(np, cfg_vit, params, device="cuda")
        feats = meshed.encode(qt_images)
        gathered = _all_gather_rows(feats)
        got = meshed.train_step(qt_images, labels, MESH_QT_BATCH)
        want = alone.train_step(qt_images, labels, MESH_QT_BATCH)
        p_mesh, p_alone = named_params(meshed), named_params(alone)
        same = all(np.array_equal(p_mesh[k], p_alone[k]) for k in p_alone)
        require(torch.equal(gathered, feats), "NCCL all_gather at one rank changed the rows")
        require(got["loss"] == want["loss"] and same,
                f"sharded Q^T step vs unsharded: loss {got['loss']} vs {want['loss']}, "
                f"parameters equal {same}")
        report["nccl_one_rank"] = {"backend": backend, "loss": got["loss"],
                                   "loss_unsharded": want["loss"], "params_bit_identical": same}
        del meshed, alone
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # (d) two ranks over gloo on cuda:0
    ranks = run_mesh_ranks(np, tmp)
    feats0 = torch.from_numpy(ranks[0]["features"])
    ref_cpu = ref_bf16.float().cpu()
    cos_d = float(row_cosines(torch, feats0, ref_cpu).min())
    err_d = float((feats0 - ref_cpu).abs().max())
    param_keys = [k for k in ranks[0] if k.startswith("param/")]
    ranks_same = all(np.array_equal(ranks[0][k], ranks[1][k]) for k in param_keys)
    require(all(bool(r["gathered_equal"]) for r in ranks), "a rank's gather changed the rows")
    require(np.array_equal(ranks[0]["features"], ranks[1]["features"]),
            "the two ranks gathered different features")
    require(cos_d >= MESH_COSINE, f"two gloo ranks vs one process: cosine {cos_d}, "
            f"max abs {err_d}")
    require(ranks_same and float(ranks[0]["loss"]) == float(ranks[1]["loss"]),
            "the two ranks' Q^T parameters differ")
    require(all(int(r["k2"]) == cfg_vit.vision_layers for r in ranks),
            f"K2 launches per rank {[int(r['k2']) for r in ranks]}")
    report["gloo_two_ranks"] = {
        "bit_identical_to_one_process": bool(torch.equal(feats0, ref_cpu)),
        "min_cosine": cos_d, "max_abs_err": err_d, "k2_launches_per_rank": [int(r["k2"])
                                                                          for r in ranks],
        "gather_ms_median": [float(np.median(r["gather_ms"])) for r in ranks],
        "qt_loss": float(ranks[0]["loss"]), "qt_params_bit_identical_across_ranks": ranks_same}

    report["routes"] = mesh_routes(torch, np, tmp, cfg_vit, params)
    emit({"phase": "mesh", "backbone": MESH_BACKBONE, "weights": "random, seed 0",
          "batch": MESH_BATCH, **report, "launches": counts,
          "seconds": time.perf_counter() - t_phase})
    return counts


def mesh_routes(torch, np, tmp, clip_cfg, params):
    """(e) The serve CLI's mesh route (MESH_SERVE_BATCH rows a device) over
    HTTP against direct calls of the serving encode on the same padded
    block, and ``cli/extract.py --mesh 1`` on the serve phase's JPEGs
    against the unsharded run, both bit for bit."""
    import base64
    import threading

    from protoclip_tpu_torch.cli import extract as extract_cli
    from protoclip_tpu_torch.cli.serve import _make_pool, _preprocess_block, build_server
    from protoclip_tpu_torch.client import ServeClient
    from protoclip_tpu_torch.io.export import make_encode_fn

    jpegs = serve_jpegs(np)
    srv = build_server(port=0, clip=(clip_cfg, params), mesh_devices=1,
                       per_device_batch=MESH_SERVE_BATCH, quiet=True, coalesce_ms=0.0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    client = ServeClient(f"http://127.0.0.1:{srv.server_address[1]}", timeout=120)
    encode = make_encode_fn(clip_cfg)
    pool = _make_pool()
    try:
        health = client.healthz()
        require(health["mesh_devices"] == 1 and health["batch_size"] == MESH_SERVE_BATCH
                and health["int8"] is False, f"mesh route /healthz {health}")
        served = []
        for n in (1, 3, 4):
            got = client.encode(jpegs[:n])
            payload = {"images": [base64.b64encode(j).decode() for j in jpegs[:n]]}
            block = np.zeros((MESH_SERVE_BATCH, 224, 224, 3), np.uint8)
            block[:n] = _preprocess_block(payload, 224, pool, False)
            want = encode(params, torch.from_numpy(block).cuda()).cpu().numpy()[:n]
            require(np.array_equal(got, want), f"mesh route, {n} images: max abs "
                    f"{float(np.abs(got - want).max())}")
            served.append(n)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        pool.shutdown(wait=False)

    img_dir = os.path.join(tmp, "mesh_jpegs")
    os.makedirs(img_dir, exist_ok=True)
    for i, data in enumerate(jpegs):
        with open(os.path.join(img_dir, f"{i:03d}.jpg"), "wb") as fh:
            fh.write(data)
    feats = {}
    argv = sys.argv
    try:
        for name, flags in (("single", []), ("mesh", ["--mesh", "1"])):
            out = os.path.join(tmp, f"mesh_extract_{name}.npz")
            sys.argv = ["extract", "--backbone", MESH_BACKBONE, "--input", img_dir, "--out", out,
                        "--batch", "16", *flags]
            extract_cli.main()
            with np.load(out) as z:
                feats[name] = z["features"]
    finally:
        sys.argv = argv
    require(feats["mesh"].shape == (len(jpegs), clip_cfg.embed_dim)
            and np.array_equal(feats["mesh"], feats["single"]),
            "extract --mesh 1 differs from the unsharded run")
    return {"serve_requests_images": served, "serve_rows_bit_identical": True,
            "healthz": {k: health[k] for k in ("mesh_devices", "per_device_batch", "batch_size",
                                               "int8", "int8_weights_prequantized")},
            "extract_rows": int(feats["mesh"].shape[0]), "extract_bit_identical": True}


# -- 12. the validators: FewSOL-198's experiment through run(), ViT-B/32's full run ---------

EXPERIMENT_CONFIG = TOOLKIT_CONFIG
# the cuts of the shipped config: shots 16 -> 4, augment_epoch 10 -> 2, and
# 2 val and 2 test JPEGs a class; ViT-L/14, 198 classes, alpha, beta, the
# adapter and top-k stay as shipped
EXPERIMENT_SHOTS, EXPERIMENT_AUGMENT, EXPERIMENT_EVAL = 4, 2, 2
EXPERIMENT_CPU_ROWS = 8
EXPERIMENT_COSINE = {"bf16": 0.999, "int8": 0.995}  # PERF.md section 2's bars
EXPERIMENT_JPEG_THREADS = 8


def write_fewsol_tree(np, data_root, shots, n_eval):
    """FewSOL-198's layout (``data/registry.py``'s fewsol_198: JPEGs under
    ``<root>/fewsol/data/`` and ``fewsol_splits_198.json`` in the dataset
    dir): 198 class folders of 480 x 640 JPEGs, each a class colour plus
    noise drawn from the seed, ``shots`` train and ``n_eval`` val and test
    images a class.  Returns the number of JPEGs."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    colours = np.random.default_rng(SEED).integers(0, 200, (TOOLKIT_N_CLASS, 3)).astype(np.uint8)
    img_dir = os.path.join(data_root, "fewsol", "data")
    rows = {"train": [], "val": [], "test": []}
    jobs = []
    for c in range(TOOLKIT_N_CLASS):
        cname = f"object_{c:03d}"
        os.makedirs(os.path.join(img_dir, cname))
        for split, count in (("train", shots), ("val", n_eval), ("test", n_eval)):
            for i in range(count):
                rel = f"{cname}/{split}_{i}.jpg"
                rows[split].append([rel, c, cname])
                jobs.append((rel, c, len(jobs)))

    def write(job):
        rel, c, k = job
        noise = np.random.default_rng([SEED, k]).integers(0, 56, (*FRAME_HW, 3), dtype=np.uint8)
        Image.fromarray(colours[c] + noise).save(os.path.join(img_dir, rel), quality=95)

    with ThreadPoolExecutor(EXPERIMENT_JPEG_THREADS) as pool:
        list(pool.map(write, jobs))
    with open(os.path.join(data_root, "fewsol", "fewsol_splits_198.json"), "w") as fh:
        json.dump(rows, fh)
    return len(jobs)


@contextlib.contextmanager
def recording_runs(torch, runs):
    """Wrap ``train.runner.run`` for the validators, which call it: for each
    run, the launch counts set to 0 just before it and read just after, its
    image encode calls and rows and text encode calls, the visual bank
    build's seconds and images (the card synchronized around it), the card
    seconds of the image encode calls (CUDA events on the stream around each
    call, summed: the tower's share; decode, collation and the host-to-card
    copy lie outside them), in the bank build and in the whole run, and the
    run's wall seconds, appended to ``runs``.  An encode call's rows include
    the zero rows that pad the loader's last batch."""
    from protoclip_tpu_torch.ops import kernels as K
    from protoclip_tpu_torch.train import runner

    real = (runner.run, runner.encode_image, runner.encode_text,
            runner.build_visual_memory_bank)
    now = {}

    def encode_image(params, images, cfg, **kwargs):
        now["image_calls"] += 1
        now["image_rows"] += int(images.shape[0])
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real[1](params, images, cfg, **kwargs)
        end.record()
        now["image_events"].append((start, end))
        return out

    def card_s(events):
        return sum(start.elapsed_time(end) for start, end in events) / 1e3

    def encode_text(*args, **kwargs):
        now["text_calls"] += 1
        return real[2](*args, **kwargs)

    def build_visual_memory_bank(encode_fn, loader, augment_epochs, *args, **kwargs):
        torch.cuda.synchronize()
        t0, rows, calls = time.perf_counter(), now["image_rows"], len(now["image_events"])
        out = real[3](encode_fn, loader, augment_epochs, *args, **kwargs)
        torch.cuda.synchronize()
        now["bank_s"] += time.perf_counter() - t0
        now["bank_card_s"] += card_s(now["image_events"][calls:])
        now["bank_rows"] += now["image_rows"] - rows
        if now["image_rows"] > rows:  # the loader pads its last batch: count images
            now["bank_images"] += loader.num_items * augment_epochs
        return out

    def run(cfg, *args, **kwargs):
        now.clear()
        now.update(image_calls=0, image_rows=0, text_calls=0, bank_s=0.0, bank_rows=0,
                   bank_images=0, bank_card_s=0.0, image_events=[])
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        result = real[0](cfg, *args, **kwargs)
        torch.cuda.synchronize()
        wall_s, events = time.perf_counter() - t0, now.pop("image_events")
        runs.append({"cfg": cfg, "int8": kwargs.get("int8"), "result": result, "wall_s": wall_s,
                     "image_card_s": card_s(events), "launches": K.launch_counts(), **now})
        return result

    runner.run, runner.encode_image, runner.encode_text = run, encode_image, encode_text
    runner.build_visual_memory_bank = build_visual_memory_bank
    try:
        yield runs
    finally:
        (runner.run, runner.encode_image, runner.encode_text,
         runner.build_visual_memory_bank) = real


@contextlib.contextmanager
def shared_random_init(torch):
    """``load_clip``'s random initialization drawn once per backbone and
    generator state and shared by the loads inside the block: the stand-in
    for the weights file a deployment reads, whose numpy draw (seconds for
    ViT-L/14's 428M parameters on one host core) would otherwise repeat at
    every run's load.  The weights are the same draws as without it."""
    from protoclip_tpu_torch.models import clip

    real, memo = clip.init_clip_params, {}

    def init_clip_params(rng, cfg, dtype=torch.float32):
        key = (repr(cfg), json.dumps(rng.bit_generator.state, sort_keys=True), str(dtype))
        if key not in memo:
            memo[key] = real(rng, cfg, dtype)
        return memo[key]

    clip.init_clip_params = init_clip_params
    try:
        yield
    finally:
        clip.init_clip_params = real


def near_ties(np, logits_img, logits_txt, alphas, betas, eps):
    """Per (alpha, beta) cell, the queries whose two best mixed scores
    ``alpha softmax(beta l_img) + (1 - alpha) softmax(beta l_txt)`` (float64)
    lie within what logits off by at most ``eps`` can swap: each score
    then moves by a factor within exp(+-2 beta eps), so a relative margin
    above 4 beta eps (+ 1e-6 for the fp32 softmax itself) cannot flip."""
    def softmax(x):
        e = np.exp(x - x.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    l_img, l_txt = logits_img.astype(np.float64), logits_txt.astype(np.float64)
    ties = np.zeros((len(alphas), len(betas)), np.int64)
    for j, beta in enumerate(np.asarray(betas, np.float64)):
        p_img, p_txt = softmax(beta * l_img), softmax(beta * l_txt)
        for i, alpha in enumerate(np.asarray(alphas, np.float64)):
            top2 = np.sort(alpha * p_img + (1 - alpha) * p_txt, axis=1)[:, -2:]
            ties[i, j] = int((top2[:, 1] - top2[:, 0] <= (4 * beta * eps + 1e-6) * top2[:, 1])
                             .sum())
    return ties


def recompute_on_cpu(torch, np, cfg, run):
    """The zero-shot val grid and ``test_acc_fixed`` recomputed in fp32 on
    the CPU from the card's cached features and the triple, against the
    card's cached grid and result.  Two devices sum a dot product in other
    orders, so a query whose two best classes tie to within that rounding
    may fall either way (random weights give near-equal features): each
    cell's count may differ from the card's by at most its near ties
    (:func:`near_ties`, with ``eps`` the largest difference of the card's
    logits from the CPU's, both computed here)."""
    from protoclip_tpu_torch.core import accuracy, from_arrays
    from protoclip_tpu_torch.eval import alpha_beta_sweep, default_alpha_beta_grid
    from protoclip_tpu_torch.io import checkpoint_paths, load_checkpoint_triple
    from protoclip_tpu_torch.memory import FeatureCache
    from protoclip_tpu_torch.models import adapter_from_torch_state
    from protoclip_tpu_torch.ops.proto import proto_logits

    cache = FeatureCache(cfg.cache_dir, cfg.backbone, cfg.shots)
    keys = cache.load(cache.visual_bank_stems(cfg.augment_epoch)[0])["keys"]
    bank_t = cache.load(cache.text_bank_stem())["bank"]
    split = {s: (cache.load(f"{s}_features")["features"], cache.load(f"{s}_labels")["labels"])
             for s in ("val", "test")}
    alphas, betas = default_alpha_beta_grid()
    txt_p = torch.from_numpy(bank_t / np.linalg.norm(bank_t, axis=-1, keepdims=True))
    logits = {}
    for device in ("cpu", "cuda"):
        img_p = from_arrays(keys, bank_t, {}, "fc", cfg.shots, device=device).prototypes()[0]
        q = torch.from_numpy(split["val"][0]).to(device)
        with torch.inference_mode():
            logits[device] = [proto_logits(q, p.to(device)).cpu().numpy()
                              for p in (img_p, txt_p)]
        if device == "cpu":
            grid = alpha_beta_sweep(*split["val"], img_p, txt_p.numpy(), alphas, betas)
    eps = max(float(np.abs(a - b).max()) for a, b in zip(logits["cpu"], logits["cuda"]))
    n = len(split["val"][1])
    card_grid = cache.load(cache.hp_search_stem("val"))["acc"]
    moved = np.abs(np.rint(grid * n) - np.rint(card_grid * n)).astype(np.int64)
    ties = near_ties(np, *logits["cpu"], alphas, betas, eps)
    bank_v, bank_tt, state = load_checkpoint_triple(*checkpoint_paths(
        cfg.cache_dir, cfg.backbone, cfg.shots, cfg.alpha, cfg.beta, cfg.lr, cfg.augment_epoch,
        cfg.train_epoch))
    model = from_arrays(bank_v, bank_tt, adapter_from_torch_state(state, cfg.adapter),
                        cfg.adapter, cfg.shots, device="cpu")
    acc = accuracy(model, *split["test"], cfg.alpha, cfg.beta)
    return {"grid_max_diff": float(np.abs(grid - card_grid).max()),
            "grid_cells_moved": int((moved > 0).sum()), "grid_queries_moved": int(moved.sum()),
            "grid_moves_beyond_near_ties": int(np.maximum(moved - ties, 0).sum()),
            "near_ties": int(ties.sum()), "logit_eps_card_vs_cpu": eps,
            "test_acc_fixed_diff": abs(acc - run["result"].test_acc_fixed)}


def validator_summary(run):
    r = run["result"]
    return {"wall_s": run["wall_s"], "bank_s": run["bank_s"], "bank_images": run["bank_images"],
            "bank_rows_encoded": run["bank_rows"], "bank_image_encode_card_s": run["bank_card_s"],
            "image_encode_card_s": run["image_card_s"],
            "bank_images_per_s": run["bank_images"] / run["bank_s"] if run["bank_s"] else None,
            "image_encode_calls": run["image_calls"], "image_rows": run["image_rows"],
            "text_encode_calls": run["text_calls"],
            "K2": run["launches"]["fused_transformer_block"],
            "K3": run["launches"]["fused_transformer_block_int8"],
            "random_weight_accuracies_plumbing_only": {
                "zero_shot_val_best": r.zero_shot.get("val_best_acc"),
                "test_acc_fixed": r.test_acc_fixed, "test_acc_searched": r.test_acc_searched}}


def check_fewsol_runs(cfgs, first, rerun, tables, records):
    """(a)'s checks on the runs :func:`recording_runs` recorded."""
    from protoclip_tpu_torch.models import BACKBONE_CONFIGS

    vitl = BACKBONE_CONFIGS["ViT-L/14"]
    for name, table in tables.items():
        require("ERROR" not in table and "skip" not in table
                and not any("error" in r for r in records[name]),
                f"validate_accuracy's {name} table has a failed row: {records[name]}")
    for mode, cfg in cfgs.items():
        r, rr = first[mode], rerun[mode]
        require(r["cfg"].cache_root == rr["cfg"].cache_root == cfg.cache_root
                and r["int8"] is rr["int8"] is (mode == "int8"),
                f"{mode}: a run's mode or cache tree is not its own")
        per = vitl.vision_layers * r["image_calls"] + vitl.transformer_layers * r["text_calls"]
        k2 = r["launches"]["fused_transformer_block"]
        k3 = r["launches"]["fused_transformer_block_int8"]
        require(r["image_calls"] > 0 and r["text_calls"] > 0
                and (k2, k3) == ((per, 0) if mode == "bf16" else (0, per)),
                f"{mode}: K2 {k2}, K3 {k3} for {r['image_calls']} image and "
                f"{r['text_calls']} text encodes of ViT-L/14")
        require(r["bank_images"] == TOOLKIT_N_CLASS * EXPERIMENT_SHOTS * EXPERIMENT_AUGMENT,
                f"{mode}: the bank build encoded {r['bank_images']} images")
        require(rr["image_calls"] == rr["text_calls"] == 0 and not any(rr["launches"].values()),
                f"{mode}: the cached rerun encoded ({rr['image_calls']} image, "
                f"{rr['text_calls']} text calls) or launched {rr['launches']}")
        require(rr["result"].test_acc_fixed == r["result"].test_acc_fixed,
                f"{mode}: the rerun's test_acc_fixed {rr['result'].test_acc_fixed} is not "
                f"{r['result'].test_acc_fixed}")


def check_vit_b32_runs(full, cached, rc, summary):
    """(b)'s checks: ``validate_experiment``'s full run and its rerun."""
    from protoclip_tpu_torch.models import BACKBONE_CONFIGS

    vitb = BACKBONE_CONFIGS["ViT-B/32"]
    require(rc == 0 and summary.get("ok") is True, f"validate_experiment returned {rc}")
    require(not full["cfg"].only_test and cached["cfg"].only_test
            and full["cfg"].backbone == "ViT-B/32", "validate_experiment's runs")
    per = vitb.vision_layers * full["image_calls"] + vitb.transformer_layers * full["text_calls"]
    require(full["image_calls"] > 0 and full["launches"]["fused_transformer_block"] == per
            and full["launches"]["fused_transformer_block_int8"] == 0,
            f"ViT-B/32 full run: launches {full['launches']} for {full['image_calls']} image "
            f"and {full['text_calls']} text encodes")
    require(full["result"].best_epoch >= 0, "the full run trained no epoch")
    require(cached["image_calls"] == cached["text_calls"] == 0
            and not any(cached["launches"].values())
            and cached["result"].test_acc_fixed == full["result"].test_acc_fixed,
            f"ViT-B/32 only_test rerun: launches {cached['launches']}, test_acc_fixed "
            f"{cached['result'].test_acc_fixed} vs {full['result'].test_acc_fixed}")


def cpu_val_rows(torch, np, data_root, seed):
    """The fp32 ViT-L/14 on the CPU (the same seeded weights) over the
    first EXPERIMENT_CPU_ROWS val images, preprocessed as the runner's
    loader does; returns (features, seconds)."""
    from protoclip_tpu_torch.data import EvalTransform, build_dataset, load_image, normalize_batch
    from protoclip_tpu_torch.models import encode_image, load_clip

    dataset = build_dataset("fewsol_198", data_root, EXPERIMENT_SHOTS, seed=seed)
    t0 = time.perf_counter()
    with torch.inference_mode():
        cfg, params = load_clip("ViT-L/14", dtype=torch.float32, device="cpu", seed=SEED)
        pixels = np.stack([EvalTransform(cfg.image_resolution)(load_image(d.impath))
                           for d in dataset.val[:EXPERIMENT_CPU_ROWS]])
        feats = encode_image(params, normalize_batch(torch.from_numpy(pixels), torch.float32), cfg)
    return feats, time.perf_counter() - t0


def phase_experiment(torch, np, tmp):
    """The port's validators through their own ``main()``s on the card, with
    random weights (seed 0, drawn once: :func:`shared_random_init`) and the
    synthetic tokenizer:

    (a) ``scripts.validate_accuracy --only fewsol_198 --int8`` with the
        shipped ``configs/fewsol_198.yml`` (``only_test``) on ViT-L/14 at
        full width over a FewSOL-198-layout tree of 480 x 640 JPEGs, cut as
        EXPERIMENT_SHOTS / _AUGMENT / _EVAL say, scoring a triple written
        first where the runner reads it, in both cache trees; then again,
        where both modes must come from the caches (no encode, no launch)
        with the same ``test_acc_fixed``.  The bf16 run must launch K2 once
        a layer an encode and no K3, the int8 run K3 and no K2; 8 val rows
        of each tree's cached features are held against the fp32 ViT-L/14
        on the CPU from the same pixels, and the zero-shot grid and
        ``test_acc_fixed`` recomputed on the CPU from the cached features
        (:func:`recompute_on_cpu`);
    (b) ``scripts.validate_experiment`` at its default, ViT-B/32: a full
        ``run(only_test=False)`` (K2 12 an encode) and its cached
        ``only_test`` rerun (no launch, the same accuracy).

    The launch counts are set to 0 just before each run and read just after
    it (:func:`recording_runs`).  Returns the launches of (a)'s bf16 and
    int8 runs and of (b)'s full run."""
    import io

    from protoclip_tpu_torch.core import load_config
    from protoclip_tpu_torch.memory import FeatureCache, banks
    from protoclip_tpu_torch.scripts import validate_accuracy, validate_experiment

    t_phase = time.perf_counter()
    banks.tokenize = synthetic_tokenize  # the BPE vocab is not in the repository
    root = os.path.join(tmp, "experiment")
    data_root = os.path.join(root, "DATA")
    t0 = time.perf_counter()
    n_jpegs = write_fewsol_tree(np, data_root, EXPERIMENT_SHOTS, EXPERIMENT_EVAL)
    jpeg_s = time.perf_counter() - t0
    overrides = {"shots": EXPERIMENT_SHOTS, "augment_epoch": EXPERIMENT_AUGMENT,
                 "cache_root": os.path.join(root, "caches"),
                 "logs_dir_path": os.path.join(root, "logs")}
    cfgs = {"bf16": load_config(EXPERIMENT_CONFIG, root_path=data_root, **overrides)}
    cfgs["int8"] = load_config(EXPERIMENT_CONFIG, root_path=data_root,
                               **{**overrides, "cache_root": overrides["cache_root"] + "-int8"})
    for cfg in cfgs.values():
        write_fewsol_triple(torch, np, cfg)
    argv = ["--only", "fewsol_198", "--data-root", data_root, "--config-dir",
            os.path.dirname(EXPERIMENT_CONFIG), "--int8",
            *(arg for key, value in overrides.items() for arg in ("--set", f"{key}={value}"))]
    runs, tables, records = [], {}, {}
    out = io.StringIO()
    with shared_random_init(torch):
        with recording_runs(torch, runs):
            for name in ("first", "rerun"):
                path = os.path.join(root, f"ACCURACY_{name}.md")
                validate_accuracy.main([*argv, "--out", path])
                with open(path) as fh:
                    tables[name] = fh.read()
                with open(path + ".json") as fh:
                    records[name] = json.load(fh)
            try:
                with contextlib.redirect_stdout(out):
                    rc = validate_experiment.main([])
            finally:
                print(out.getvalue(), file=sys.stderr, end="")
        cpu_f, cpu_s = cpu_val_rows(torch, np, data_root, cfgs["bf16"].seed)

    require(len(runs) == 6, f"the validators ran run() {len(runs)} times, expected 6")
    first = {"bf16": runs[0], "int8": runs[1]}
    rerun = {"bf16": runs[2], "int8": runs[3]}
    full, cached = runs[4], runs[5]
    check_fewsol_runs(cfgs, first, rerun, tables, records)
    cos, recomputed = {}, {}
    for mode, cfg in cfgs.items():
        cache = FeatureCache(cfg.cache_dir, cfg.backbone, cfg.shots)
        card = torch.from_numpy(cache.load("val_features")["features"][:EXPERIMENT_CPU_ROWS])
        cos[mode] = row_cosines(torch, card.float(), cpu_f).tolist()
        recomputed[mode] = recompute_on_cpu(torch, np, cfg, first[mode])
        require(min(cos[mode]) >= EXPERIMENT_COSINE[mode],
                f"{mode}: card vs CPU fp32 val row cosines {cos[mode]}")
        require(recomputed[mode]["grid_moves_beyond_near_ties"] == 0
                and recomputed[mode]["test_acc_fixed_diff"] <= 1e-6,
                f"{mode}: the CPU's grid and accuracy from the card's caches: {recomputed[mode]}")
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    check_vit_b32_runs(full, cached, rc, summary)

    cfg = cfgs["bf16"]
    emit({
        "phase": "experiment", "nvidia_smi": summary["power_limit"],
        "weights": "random, seed 0 (drawn once, shared by the runs)",
        "tokenizer": "synthetic: the BPE vocab is not in the repository",
        "accuracies": "random weights: plumbing checks, not results",
        "fewsol_198": {
            "config": EXPERIMENT_CONFIG, "backbone": cfg.backbone, "n_class": TOOLKIT_N_CLASS,
            "alpha": cfg.alpha, "beta": cfg.beta, "adapter": cfg.adapter, "top_k": cfg.top_k,
            "only_test": cfg.only_test, "batch_size": cfg.batch_size,
            "reduced": {"shots": [16, EXPERIMENT_SHOTS], "augment_epoch": [10, EXPERIMENT_AUGMENT],
                        "val_per_class": EXPERIMENT_EVAL, "test_per_class": EXPERIMENT_EVAL},
            "jpegs": n_jpegs, "jpeg_hw": list(FRAME_HW), "jpeg_write_s": jpeg_s,
            "runs": {mode: validator_summary(first[mode]) for mode in cfgs},
            "reruns_from_cache": {
                mode: {"wall_s": rerun[mode]["wall_s"],
                       "launches": sum(rerun[mode]["launches"].values()),
                       "encode_calls": rerun[mode]["image_calls"] + rerun[mode]["text_calls"],
                       "test_acc_fixed": rerun[mode]["result"].test_acc_fixed}
                for mode in cfgs},
            "cos_vs_cpu_fp32_val_rows": cos, "cpu_fp32_reference_s": cpu_s,
            "recomputed_on_cpu": recomputed, "table_row": tables["first"].splitlines()[-1]},
        "vit_b32_full_run": {"validate_experiment": summary, "full": validator_summary(full),
                             "only_test_rerun_wall_s": cached["wall_s"],
                             "only_test_rerun_launches": sum(cached["launches"].values())},
        "seconds": time.perf_counter() - t_phase})
    torch.cuda.empty_cache()
    return first["bf16"]["launches"], first["int8"]["launches"], full["launches"]


# -- 13. the repository's tools: bundle validator, serving bench and the probes ---------

TOOLS_SERVE_REQUESTS, TOOLS_SERVE_IMAGES = 32, 8
TOOLS_SERVE_TIMEOUT_S = 300


def tool_main(main, argv):
    """(exit code, the tool's last JSON line) of a tool's ``main(argv)`` run
    in this process; its stdout goes to stderr, so this script's stdout
    keeps one line a phase."""
    import io

    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = main(argv)
    finally:
        print(out.getvalue(), file=sys.stderr, end="")
    return rc, last_json(out.getvalue())


def last_json(text):
    """The last line of ``text`` that is a JSON object, parsed (None if
    there is none)."""
    lines = [line for line in text.splitlines() if line.startswith("{")]
    return json.loads(lines[-1]) if lines else None


def serve_bench(tmp, mode):
    """``scripts.bench_serve_http`` over a ViT-B/16 bundle (batch 256,
    buckets 8 and 64) in a subprocess, as the JAX script is run: it exports
    in a child, serves from another and drives it from a process with no
    CUDA call.  Returns its JSON line and its port, which must be closed
    once it has exited: the server was stopped."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = [sys.executable, "-m", "protoclip_tpu_torch.scripts.bench_serve_http",
            "--batch", str(SERVE_BATCH), "--buckets", *map(str, SERVE_BUCKETS),
            "--requests", str(TOOLS_SERVE_REQUESTS),
            "--images-per-request", str(TOOLS_SERVE_IMAGES),
            "--bundle", os.path.join(tmp, f"serve_bench_{mode}"), "--port", str(port),
            "--warmup-timeout", str(TOOLS_SERVE_TIMEOUT_S), *(["--int8"] if mode == "int8" else [])]
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=2 * TOOLS_SERVE_TIMEOUT_S)
    print(proc.stderr[-4000:], file=sys.stderr)
    require(proc.returncode == 0, f"bench_serve_http ({mode}) exited {proc.returncode}: "
            f"{proc.stderr[-2000:]}")
    line = last_json(proc.stdout)
    with socket.socket() as s:
        stopped = s.connect_ex(("127.0.0.1", port)) != 0
    require(stopped, f"bench_serve_http ({mode}) left its server listening on {port}")
    require(line["serial_dispatches"] == TOOLS_SERVE_REQUESTS
            and 1 <= line["concurrent_dispatches"] <= TOOLS_SERVE_REQUESTS,
            f"bench_serve_http ({mode}) dispatches: {line}")
    return {**line, "server_stopped": stopped}


def phase_tools(torch, np, tmp):
    """The repository's remaining tools, ported under ``protoclip_tpu_torch/
    scripts/``, at their sizes on the card (random weights, seed 0):

    (1) ``validate_bundle`` on ViT-B/16 at batch 256 with buckets 8 and 64,
        bf16 and ``--int8``: the reloaded bundle equals the live encode bit
        for bit, the buckets keep the JAX bars; K2 (K3) once a layer for
        each bucket's warm-up and capture and for the live encode, the
        other block never;
    (2) ``bench_serve_http`` over the bf16 bundle (32 requests of 8 images)
        and once over an int8 bundle, each as a subprocess: serial
        dispatches equal the requests, the server stopped;
    (3) ``bench_int8_peak`` at N = 8192, 20 steps: the int8 checksum exact,
        K3.c equal to ``torch._int_mm``, K2.b within bf16's bars of
        ``torch.matmul``;
    (4) ``bench_rn50_int8`` at B = 256, 20 steps: every int8 product within
        a cosine of 0.99 of the bf16 convolution (no im2col + K3.b line for
        layer4.conv2, whose rows are wider than K3.b takes);
    (5) ``bench_episodic_sharding`` at ImageNet's shape on a mesh of the
        card and on two shards of it: the parameters within 1e-6.

    Each tool's own check fails its exit code, and a non-zero code fails
    the phase.  Returns the launches of the in-process tools (1, 3-5)."""
    from protoclip_tpu_torch.models.clip import BACKBONE_CONFIGS
    from protoclip_tpu_torch.ops import kernels as K
    from protoclip_tpu_torch.scripts import (
        bench_episodic_sharding,
        bench_int8_peak,
        bench_rn50_int8,
        validate_bundle,
    )
    from protoclip_tpu_torch.scripts.validate_experiment import describe_device

    t_phase = time.perf_counter()
    K.reset_launch_counts()
    lines, seconds = {}, {}
    layers = BACKBONE_CONFIGS[SERVE_BACKBONE].vision_layers
    buckets = len(SERVE_BUCKETS) + 1
    for mode in ("bf16", "int8"):
        blocks = ("fused_transformer_block", "fused_transformer_block_int8")
        block, other = blocks[::-1] if mode == "int8" else blocks
        before = K.launch_counts()
        t0 = time.perf_counter()
        rc, line = tool_main(validate_bundle.main, [
            "--batch", str(SERVE_BATCH), "--buckets", *map(str, SERVE_BUCKETS),
            *(["--int8"] if mode == "int8" else [])])
        seconds[f"validate_bundle_{mode}"] = time.perf_counter() - t0
        after = K.launch_counts()
        launched = {k: after[k] - before[k] for k in (block, other)}
        require(rc == 0, f"validate_bundle ({mode}) failed")
        # each bucket's warm-up and capture, and the live encode
        require(launched[block] == layers * (2 * buckets + 1) and launched[other] == 0,
                f"validate_bundle ({mode}) launched {launched}")
        lines[f"validate_bundle_{mode}"] = {**line, "launches": launched}
    torch.cuda.empty_cache()
    for mode in ("bf16", "int8"):
        t0 = time.perf_counter()
        lines[f"bench_serve_http_{mode}"] = serve_bench(tmp, mode)
        seconds[f"bench_serve_http_{mode}"] = time.perf_counter() - t0
    for name, main, argv in (
            ("bench_int8_peak", bench_int8_peak.main, []),
            ("bench_rn50_int8", bench_rn50_int8.main, []),
            ("bench_episodic_sharding_mesh_1", bench_episodic_sharding.main,
             ["--device", "cuda", "--devices", "1"]),
            ("bench_episodic_sharding_2_shards", bench_episodic_sharding.main,
             ["--device", "cuda:0", "--devices", "2"])):
        t0 = time.perf_counter()
        rc, line = tool_main(main, argv)
        seconds[name] = time.perf_counter() - t0
        require(rc == 0, f"{name} failed: {line}")
        lines[name] = line
        torch.cuda.empty_cache()
    counts = K.launch_counts()
    for kernel in ("quant_rows", "gemm_int8_epilogue", "gemm_bias_epilogue"):
        require(counts[kernel] > 0, f"the tools launched no {kernel}: {counts}")
    emit({"phase": "tools", "nvidia_smi": describe_device(torch.device("cuda", 0))["power_limit"],
          "weights": "random, seed 0", "tools": lines,
          "seconds": seconds, "launches": {k: v for k, v in counts.items() if v},
          "phase_seconds": time.perf_counter() - t_phase})
    return counts


# -- 14. times ------------------------------------------------------------------------

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


def device_ms(torch, fn, runs=TIME_RUNS, spin_cycles=SPIN_CYCLES):
    """Median CUDA-event time of one call of ``fn`` enqueued behind a
    spinning kernel (``torch.cuda._sleep``): the host has issued every launch
    of the call before the start event runs, so the host's time to reach the
    launches, which :func:`median_ms` includes (most of it for a kernel
    shorter than its Python wrapper), is hidden and the time is the
    device's, as long as the spin outlasts the host's issue time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
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


def phase_times(torch, np, params, qparams, vitl):
    """Each kernel at the main path's encode batches: the ViT-B/16 image
    block at B=256 and the text block at B=1024; and at the toolkit's
    largest classify bucket, ViT-L/14's image block at B=16 (``vitl``: its
    bf16 and int8 parameters).  Layer 0's weights, and layer 0's int8 layer
    for K3."""
    import torch.nn.functional as F

    from protoclip_tpu_torch.ops import kernels as K

    bf16 = torch.bfloat16
    shapes = {"image": (params, qparams, "visual", 256, 197, 12, False),
              "text": (params, qparams, "text", 1024, 77, 8, True),
              "vitl_image": (*vitl, "visual", TOOLKIT_MAX_BATCH, 257, 16, False)}
    results = {}
    for tag, (tparams, tqparams, tower, b, l, h, causal) in shapes.items():
        blk, qb = tparams[tower]["blocks"][0], tqparams[tower]["blocks_q"][0]
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


def device_ms_by_kind(prof, prefix="rn50_profiled"):
    """One profiled call's device time by kind of kernel (convolutions and
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
    return {f"{prefix}_device_ms_by_kind": kinds or None,
            f"{prefix}_top_kernels": [{"ms": ms, "calls": n, "name": k}
                                      for ms, n, k in kernels[:10]]}
    return out


# -- 15. the block-variant bench (S1) -------------------------------------------------------

# one variant per distinct chain: the TPU script's schedule-only twins (v3-v7,
# v9, v6g8, v2g8, v2g32, int8g8, int8g32) run their twin's chain, so they
# would repeat its launches and checksum
VARIANTS = (
    "v0 v1 v2 v10 "
    "int8 int8h int8gb int8noattn int8static int8recip int8cast int8lnb int8s "
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
    """The port's block-variant bench on the card: the variants of
    VARIANTS at the full ViT-B/16 geometry, and four at ViT-L/14, each
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
    # the same core at the bench's ViT-L/14 geometry (B=128, LP=264, length
    # 257, D=1024, 16 heads), on a seeded QKV buffer
    gl = bv.geometry({"BENCH_GEOM": "vitl"})
    dl, hl = gl.width, gl.heads
    qkv_l = torch.randn(gl.batch, gl.padded, 3 * dl, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED)).to(bf16)
    sl_l = (qkv_l[..., :dl], qkv_l[..., dl:2 * dl], qkv_l[..., 2 * dl:])
    keep_l = (torch.arange(gl.padded, device=dev) < gl.length)[None, :]

    def heads_l(t):
        return t.reshape(gl.batch, gl.padded, hl, dl // hl).transpose(1, 2)

    entry("attention_int8.vit_l14", int8_attention_rule(sl_l[2]),
          lambda: K.attention_int8(*sl_l, hl, gl.length, gl.group),
          lambda: K.attention_int8_plain(*sl_l, hl, gl.length, gl.group),
          lambda: F.scaled_dot_product_attention(*map(heads_l, sl_l), attn_mask=keep_l),
          4 * gl.batch * gl.padded * dl * 2, {"int8": 4 * gl.batch * gl.padded * gl.length * dl})
    r["attention_int8.vit_l14"]["geometry"] = [gl.batch, gl.padded, gl.length, dl, hl, gl.group]
    del qkv_l, sl_l
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


# -- 16. the contract line ------------------------------------------------------------

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


def phase_kernels(counts, times, vtimes, serve):
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
    ``device_ms`` the same call's device time (:func:`device_ms`).  ``serve``
    holds the serving path's launches: per replay of each bundle bucket's
    CUDA graph (counted when it was captured; a replay counts none) and per
    /classify dispatch of the served traffic."""
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
            "serve": {"per_replay": {mode: {str(size): n.get(name, 0)
                                            for size, n in sorted(buckets.items())}
                                     for mode, buckets in serve["per_replay"].items()},
                      "per_classify_call": serve["per_classify_call"].get(name, 0)},
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

    from protoclip_tpu_torch import native
    from protoclip_tpu_torch.ops import kernels as K

    # the host preprocess on the native resize + crop: a missing library
    # raises instead of falling back to PIL
    os.environ["PROTOCLIP_NATIVE"] = "1"
    info = phase_device(torch)
    emit({"phase": "native", "preprocess": "native" if native.load() is not None else "PIL",
          "library": native._build()})
    phase_build()
    K.reset_launch_counts()
    phase_check(torch, np)
    counts = {"check": K.launch_counts()}
    cfg, params, counts["main"], data, ref = phase_main(torch, np)
    _, qparams, counts["main_int8"] = phase_main_int8(torch, np, data, ref)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        rn_cfg, rn_setup, counts["runner"], runner_cfg = phase_runner(torch, np, tmp)
        counts["train"] = phase_train(torch, np, tmp, runner_cfg, rn_setup)
        counts["train_qt"] = phase_train_qt(torch, np, tmp)
        counts["toolkit"], counts["toolkit_int8"], *vitl, clf = phase_toolkit(torch, np, tmp)
        counts["serve_start"], counts["serve"], serve = phase_serve(torch, np, tmp, clf)
        del clf
        torch.cuda.empty_cache()
        counts["mesh"] = phase_mesh(torch, np, tmp)
        (counts["experiment"], counts["experiment_int8"],
         counts["experiment_vit_b32"]) = phase_experiment(torch, np, tmp)
        counts["tools"] = phase_tools(torch, np, tmp)
    rn_params = rn_setup.clip_params
    del rn_setup
    torch.cuda.empty_cache()
    times = phase_times(torch, np, params, qparams, vitl)
    phase_encode_times(torch, cfg, params, qparams, rn_cfg, rn_params)
    del params, qparams, rn_params, vitl
    torch.cuda.empty_cache()
    _, counts["variants"] = phase_variants(torch, np)
    vtimes = phase_variant_times(torch, np)
    phase_kernels(counts, times, vtimes, serve)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--loadgen"]:
        sys.exit(loadgen_main(sys.argv[2:]))
    sys.exit(mesh_rank_main(sys.argv[2:]) if sys.argv[1:2] == ["--mesh-rank"] else main())
