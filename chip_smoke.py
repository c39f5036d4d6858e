#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``protoclip_tpu_torch``) on one NVIDIA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, one JSON line each on stdout:

1. device  - require CUDA; the card's name and power limit from nvidia-smi.
2. build   - compile ``protoclip_tpu_torch/csrc/*.cu`` with nvcc (sm_90a).
3. check   - every CUDA kernel, and the K1, K2, K3 and K4 entries, against
             its plain PyTorch version on the card at the ViT-B/16, text,
             ViT-L/14 and ViT-B/32 block geometries.
4. main    - zero-shot Proto-CLIP on ViT-B/16 at full width with random
             weights: memory banks, prototypes, the alpha/beta sweep and the
             accuracy, with the kernels' launch counts of that run, and the
             card's features held against the plain path in fp32 on the CPU.
5. main_int8 - the same run in the W8A8 serving mode ($PROTOCLIP_INT8:
             load_clip quantizes, every layer is K3), plus the serving encode
             (io.make_encode_fn) on a fixed uint8 batch, with its own launch
             counts, held against the same fp32 CPU features.
6. times   - each kernel, its plain version, one PyTorch library call for
             the same function and the bound, at the main path's encode
             batches (images B=256, prompts B=1024), and the encode rates in
             bf16 (K2) and int8 (K3).
7. kernels - the contract line: every ported kernel with the path or phase
             that launched it, its launches, error, times and bound.

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

    def dname(dtype):
        return str(dtype).replace("torch.", "")

    def record(kernel, geom, dtype, out, ref, bars=BARS, **extra):
        torch.cuda.synchronize()
        rel, cos, diff = compare(out, ref)
        lim_rel, lim_cos = bars[dname(dtype)]
        ok = rel < lim_rel and cos > lim_cos
        rows.append({"kernel": kernel, "geometry": geom, "dtype": dname(dtype), "rel": rel,
                     "cos": cos, "max_abs_err": diff, "ok": ok, **extra})

    def record_exact(kernel, geom, dtype, outs, refs, **extra):
        """Bit-exact: every output tensor equal to the plain version's."""
        torch.cuda.synchronize()
        equal = all(torch.equal(o, r) for o, r in zip(outs, refs))
        diff = max(float((o.double() - r.double()).abs().max()) for o, r in zip(outs, refs))
        rows.append({"kernel": kernel, "geometry": geom, "dtype": dname(dtype),
                     "bit_exact": equal, "max_abs_err": diff, "ok": equal, **extra})

    def record_ln_quant(geom, dtype, got, want):
        """LN statistics sum in another order: int8 codes equal in >= 99.9%
        of entries, never more than one step apart, scales within 1e-6."""
        torch.cuda.synchronize()
        (q, sc), (rq, rsc) = got, want
        step = (q.int() - rq.int()).abs()
        equal_share = float((step == 0).float().mean())
        scale_rel = float(((sc - rsc).abs() / rsc).max())
        ok = int(step.max()) <= 1 and equal_share >= 0.999 and scale_rel <= 1e-6
        rows.append({"kernel": "layernorm_quant_rows", "geometry": geom, "dtype": dname(dtype),
                     "max_step": int(step.max()), "equal_share": equal_share,
                     "scale_rel": scale_rel, "max_abs_err": float(step.max()), "ok": ok})

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
            del p, qb, x, xp, h, hid_in, qkv, sl, q, k, v, qh, kh, vh, attn, hid32
            torch.cuda.empty_cache()
    for r in rows:
        emit({"phase": "check", **r})
    bad = [r for r in rows if not r["ok"]]
    require(not bad, f"{len(bad)} kernel checks failed: {bad}")
    emit({"phase": "check", "cases": len(rows), "all_ok": True})
    return rows


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


# -- 6. times ------------------------------------------------------------------------

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


def bound_ms(n_bytes, ops, dtype="bfloat16"):
    """(least ms, what bounds it, bytes ms, operations ms).  ``ops`` is a
    count in ``dtype`` or a {dtype: count} map, each at its peak rate."""
    ops = ops if isinstance(ops, dict) else {dtype: ops}
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = sum(n / PEAK_FLOPS[dt] for dt, n in ops.items()) * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations"), \
        by_bytes, by_ops


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
                "ms": median_ms(torch, kernel), "plain_ms": median_ms(torch, plain),
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


def phase_encode_times(torch, cfg, params, qparams):
    """Whole-tower encode time at the timing batches, through the kernels:
    bf16 (K2) and the W8A8 serving mode (K3)."""
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
    emit(out)
    return out


# -- 7. the contract line ------------------------------------------------------------

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


def phase_kernels(counts, times):
    """One entry per ported kernel, timed at the image block (ViT-B/16,
    B=256).  ``launches`` is the count of the run named by ``path``: the
    bf16 main path, the int8 main path, or, for K1 and K4, which no path
    runs, the check phase.  The parts of a kernel timed apiece (the four
    GEMMs of a block, quant_rows on the attention output and on the fp32
    hidden) are summed."""
    image = times["image"]["kernels"]
    rows = []
    for name, (source, replaces, path) in KERNEL_SOURCES.items():
        parts = [v for k, v in image.items() if k == name or k.startswith(name + ".")]
        lib = [pt["library_ms"] for pt in parts]
        by_bytes, by_ops = sum(pt["bytes_ms"] for pt in parts), sum(pt["ops_ms"] for pt in parts)
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "path": path, "launches": counts[path][name],
            "launches_by_path": {run: c[name] for run, c in counts.items()},
            "max_abs_err": max(pt["max_abs_err"] for pt in parts),
            "ms": sum(pt["ms"] for pt in parts),
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
    times = phase_times(torch, np, params, qparams)
    phase_encode_times(torch, cfg, params, qparams)
    phase_kernels(counts, times)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
