#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``protoclip_tpu_torch``) on one NVIDIA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, one JSON line each on stdout:

1. device  - require CUDA; the card's name and power limit from nvidia-smi.
2. build   - compile ``protoclip_tpu_torch/csrc/*.cu`` with nvcc (sm_90a).
3. check   - every CUDA kernel, and the K2 and K1 entries, against its plain
             PyTorch version on the card at the ViT-B/16, text, ViT-L/14
             and ViT-B/32 block geometries.
4. main    - zero-shot Proto-CLIP on ViT-B/16 at full width with random
             weights: memory banks, prototypes, the alpha/beta sweep and the
             accuracy, with the kernels' launch counts of that run, and the
             card's features held against the plain path in fp32 on the CPU.
5. times   - each kernel, its plain version, one PyTorch library call for
             the same function and the bound, at the main path's encode
             batches (images B=256, prompts B=1024), and the encode rates.
6. kernels - the contract line: every ported kernel with its launches,
             error, times and bound.

The last line is ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero before it; without CUDA the script exits non-zero at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense): bound = max(bytes /
# memory rate, flops / compute rate).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# Acceptance bars for a kernel against its plain version on the card:
# max|diff| / max|plain| and the flattened cosine.
BARS = {"bfloat16": (1e-2, 0.9999), "float32": (1e-5, 0.9999)}

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


def phase_build():
    from protoclip_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build(force=True)
    _build.load_library()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "library": str(_build.BUILD_DIR / _build.LIB_NAME)})


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


def phase_check(torch, np):
    from protoclip_tpu_torch.ops import kernels as K

    device = torch.device("cuda")
    np_rng = np.random.default_rng(0)
    rows = []

    def record(kernel, geom, dtype, out, ref, **extra):
        torch.cuda.synchronize()
        rel, cos, diff = compare(out, ref)
        dname = str(dtype).replace("torch.", "")
        lim_rel, lim_cos = BARS[dname]
        ok = rel < lim_rel and cos > lim_cos
        rows.append({"kernel": kernel, "geometry": geom, "dtype": dname, "rel": rel,
                     "cos": cos, "max_abs_err": diff, "ok": ok, **extra})

    for geom, (L, D, H, causal) in GEOMETRIES.items():
        for dtype in (torch.bfloat16, torch.float32):
            p = _random_block(np_rng, D, dtype, device, torch)

            def randn(*shape):
                t = torch.from_numpy(np_rng.standard_normal(shape, dtype="float32"))
                return t.to(device=device, dtype=dtype)

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
            # K2 entry, whole and pre-padded with length
            record("fused_transformer_block", geom, dtype,
                   K.fused_transformer_block(x, p, H, causal),
                   K.fused_transformer_block_plain(x, p, H, causal))
            xp = torch.nn.functional.pad(x, (0, 0, 0, 3))
            record("fused_transformer_block", geom, dtype,
                   K.fused_transformer_block(xp, p, H, causal, length=L),
                   K.fused_transformer_block_plain(xp, p, H, causal, length=L), length=L)
    for r in rows:
        emit({"phase": "check", **r})
    bad = [r for r in rows if not r["ok"]]
    require(not bad, f"{len(bad)} kernel checks failed: {bad}")
    emit({"phase": "check", "cases": len(rows), "all_ok": True})


# -- 4. the main path --------------------------------------------------------------

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


def phase_main(torch, np):
    from protoclip_tpu_torch.core import accuracy, from_arrays
    from protoclip_tpu_torch.data import ArrayLoader, normalize_batch
    from protoclip_tpu_torch.eval import alpha_beta_sweep, best_operating_point
    from protoclip_tpu_torch.eval import default_alpha_beta_grid
    from protoclip_tpu_torch.memory import banks
    from protoclip_tpu_torch.models.clip import encode_image, encode_text, load_clip
    from protoclip_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    cfg, params = load_clip("ViT-B/16", dtype=torch.bfloat16, seed=SEED)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    px = cfg.image_resolution
    np_rng = np.random.default_rng(SEED)
    colours = np_rng.integers(0, 200, (N_CLASS, 3))
    train_x, train_y = coloured_images(np_rng, colours, SHOTS, px)
    eval_x, eval_y = coloured_images(np_rng, colours, 2 * N_EVAL // N_CLASS, px)
    order = np_rng.permutation(len(eval_y))
    val = (eval_x[order[:N_EVAL]], eval_y[order[:N_EVAL]])
    test = (eval_x[order[N_EVAL:]], eval_y[order[N_EVAL:]])
    classnames = [f"class_{c}" for c in range(N_CLASS)]
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
    K.reset_launch_counts()
    t1 = time.perf_counter()
    bank_v, values = banks.build_visual_memory_bank(
        encode_fn, ArrayLoader(train_x, train_y, IMAGE_BATCH), AUGMENT, progress=False
    )
    bank_t = banks.build_textual_memory_bank(
        encode_text_fn, classnames, TEMPLATES, batch_size=TEXT_BATCH
    )
    val_f, val_l = banks.pre_load_features(encode_fn, ArrayLoader(*val, IMAGE_BATCH), "val",
                                           progress=False)
    test_f, test_l = banks.pre_load_features(encode_fn, ArrayLoader(*test, IMAGE_BATCH), "test",
                                             progress=False)
    model = from_arrays(bank_v, bank_t, {}, "fc", SHOTS)
    img_p, txt_p = model.prototypes()
    grid = alpha_beta_sweep(val_f, val_l, img_p, txt_p, alphas, betas)
    best = best_operating_point(grid, alphas, betas)
    acc = accuracy(model, test_f, test_l, 0.5, 5.0)
    probs = model.probs(test_f, 0.5, 5.0)
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
    per_call = cfg.vision_layers * calls["image"] + cfg.transformer_layers * calls["text"]
    require(counts["fused_transformer_block"] == per_call,
            f"K2 launched {counts['fused_transformer_block']} times, expected {per_call}")
    require(counts["layernorm_rows"] == 2 * per_call and counts["gemm_bias_epilogue"] == 4 * per_call
            and counts["attention_packed"] == per_call, f"kernel launches {counts}")

    # the card's bf16 features against the plain path in fp32 on the CPU
    with torch.inference_mode():
        _, cpu_params = load_clip("ViT-B/16", dtype=torch.float32, device="cpu", seed=SEED)
        imgs = torch.from_numpy(test[0][:2])
        toks = torch.from_numpy(synthetic_tokenize(["a photo of a class_1.", "art of the class_7."]))
        card_i = encode_image(params, normalize_batch(imgs.cuda(), torch.bfloat16), cfg).float().cpu()
        card_t = encode_text(params, toks.cuda(), cfg).float().cpu()
        cpu_i = encode_image(cpu_params, normalize_batch(imgs, torch.float32), cfg)
        cpu_t = encode_text(cpu_params, toks, cfg)
    cos_i = torch.nn.functional.cosine_similarity(card_i, cpu_i, dim=-1)
    cos_t = torch.nn.functional.cosine_similarity(card_t, cpu_t, dim=-1)
    require(float(cos_i.min()) >= 0.999 and float(cos_t.min()) >= 0.999,
            f"card vs CPU fp32 feature cosine: images {cos_i.tolist()}, texts {cos_t.tolist()}")
    emit({
        "phase": "main", "backbone": cfg.name, "dtype": "bfloat16", "weights": "random, seed 0",
        "tokenizer": "synthetic: the BPE vocab is not in the repository",
        "n_class": N_CLASS, "shots": SHOTS, "augment_epoch": AUGMENT, "val": N_EVAL,
        "test": N_EVAL, "image_encode_calls": calls["image"], "text_encode_calls": calls["text"],
        "launches": counts, "best_alpha": best[0], "best_beta": best[1], "best_val_acc": best[2],
        "test_acc_alpha0.5_beta5": acc, "load_s": load_s, "main_path_s": main_s,
        "cos_vs_cpu_fp32_images": cos_i.tolist(), "cos_vs_cpu_fp32_texts": cos_t.tolist(),
    })
    return cfg, params, counts


# -- 5. times ------------------------------------------------------------------------

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


def bound_ms(n_bytes, flops, dtype="bfloat16"):
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def attention_flops(b, l, d, causal):
    pairs = l * (l + 1) // 2 if causal else l * l  # keys a query attends
    return 4 * b * pairs * d


def phase_times(torch, np, params):
    """Each kernel at the main path's encode batches: the ViT-B/16 image
    block at B=256 and the text block at B=1024 (layer 0's weights)."""
    import torch.nn.functional as F

    from protoclip_tpu_torch.ops import kernels as K

    shapes = {"image": (params["visual"]["blocks"][0], 256, 197, 12, False),
              "text": (params["text"]["blocks"][0], 1024, 77, 8, True)}
    results = {}
    for tag, (blk, b, l, h, causal) in shapes.items():
        d = blk["attn"]["wo"].shape[0]
        dh = d // h
        g = torch.Generator(device="cuda").manual_seed(SEED)
        x = torch.randn(b, l, d, device="cuda", generator=g).to(torch.bfloat16)
        p = K._block_args(blk, torch.bfloat16)
        ln1 = K.layernorm_rows_plain(x, p["ln1s"], p["ln1b"])
        qkv = K.gemm_bias_epilogue_plain(ln1, p["wqkv"], p["bqkv"], "bias")
        sl = (qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:])
        attn = K.fused_attention_packed_plain(*sl, h, causal)
        hid = K.gemm_bias_epilogue_plain(ln1, p["wfc"], p["bfc"], "bias_gelu")
        m = b * l
        r = {}

        def entry(name, kernel, plain, library, n_bytes, flops):
            out, ref = kernel(), plain()
            torch.cuda.synchronize()
            bnd, by = bound_ms(n_bytes, flops)
            r[name] = {
                "ms": median_ms(torch, kernel), "plain_ms": median_ms(torch, plain),
                "library_ms": None if library is None else median_ms(torch, library),
                "bound_ms": bnd, "bound_by": by,
                "max_abs_err": float((out.float() - ref.float()).abs().max()),
            }
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
        entry("fused_transformer_block",
              lambda: K.fused_transformer_block(x, blk, h, causal),
              lambda: K.fused_transformer_block_plain(x, blk, h, causal),
              None,
              (2 * m * d + 12 * d * d + 9 * d) * 2 + 4 * d * 4,
              24 * m * d * d + attn_flops)
        results[tag] = {"batch": b, "L": l, "D": d, "heads": h, "causal": causal, "kernels": r}
        del x, ln1, qkv, sl, attn, hid, q, k, v
        torch.cuda.empty_cache()
    for tag, res in results.items():
        emit({"phase": "times", "shape": tag, **res})
    return results


def phase_encode_times(torch, cfg, params):
    """Whole-tower encode time at the timing batches, through the kernels."""
    from protoclip_tpu_torch.models.clip import encode_image, encode_text

    g = torch.Generator(device="cuda").manual_seed(SEED)
    px = cfg.image_resolution
    images = torch.randn(256, px, px, 3, device="cuda", generator=g).to(torch.bfloat16)
    tokens = torch.randint(1, SOT_ID, (1024, cfg.context_length), device="cuda", generator=g)
    tokens[:, 0] = SOT_ID
    tokens[torch.arange(1024), torch.randint(2, cfg.context_length, (1024,), device="cuda",
                                              generator=g)] = EOT_ID
    with torch.inference_mode():
        img_ms = median_ms(torch, lambda: encode_image(params, images, cfg), runs=10)
        txt_ms = median_ms(torch, lambda: encode_text(params, tokens, cfg), runs=10)
    out = {"phase": "encode_times", "image_batch": 256, "image_encode_ms": img_ms,
           "images_per_s": 256 / img_ms * 1e3, "text_batch": 1024, "text_encode_ms": txt_ms,
           "prompts_per_s": 1024 / txt_ms * 1e3}
    emit(out)
    return out


# -- 6. the contract line ------------------------------------------------------------

KERNEL_SOURCES = {  # name: (source, TPU function it replaces)
    "layernorm_rows": ("protoclip_tpu_torch/csrc/layernorm_rows.cu",
                       "protoclip_tpu/ops/pallas_kernels.py:263"),
    "gemm_bias_epilogue": ("protoclip_tpu_torch/csrc/gemm_bias_epilogue.cu",
                           "protoclip_tpu/ops/pallas_kernels.py:275"),
    "attention_packed": ("protoclip_tpu_torch/csrc/attention_packed.cu",
                         "protoclip_tpu/ops/pallas_kernels.py:145"),
    "fused_transformer_block": ("protoclip_tpu_torch/ops/kernels.py",
                                "protoclip_tpu/ops/pallas_kernels.py:252"),
}


def phase_kernels(counts, times):
    """One entry per kernel of the main path, timed at the image block
    (ViT-B/16, B=256).  The four GEMMs of a block are summed into
    ``gemm_bias_epilogue``."""
    image = times["image"]["kernels"]
    rows = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        parts = [v for k, v in image.items() if k == name or k.startswith(name + ".")]
        lib = [pt["library_ms"] for pt in parts]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name],
            "max_abs_err": max(pt["max_abs_err"] for pt in parts),
            "ms": sum(pt["ms"] for pt in parts),
            "plain_ms": sum(pt["plain_ms"] for pt in parts),
            "bound_ms": sum(pt["bound_ms"] for pt in parts),
            "bound_by": parts[0]["bound_by"],
            "library_ms": None if None in lib else sum(lib),
        })
    for row in rows:
        require(row["launches"] > 0, f"{row['name']} was not launched on the main path")
    emit({"kernels": rows})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA card",
              file=sys.stderr)
        return 2
    import numpy as np

    info = phase_device(torch)
    phase_build()
    phase_check(torch, np)
    cfg, params, counts = phase_main(torch, np)
    times = phase_times(torch, np, params)
    phase_encode_times(torch, cfg, params)
    phase_kernels(counts, times)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
