"""Time the fp32 GEMM and attention of several builds side by side.

    python -m protoclip_tpu_torch.scripts.fp32_kernels [--gemm A.cu ...] [--attention B.cu ...]

Compiles each given ``gemm_bias_epilogue.cu`` and ``attention_packed.cu``
(by default the package's own, from ``csrc/``; the package's own is always
the first of each list) alone with nvcc into a library of its own, and
runs their fp32 entries on the same inputs at K2's shapes: the ViT-B/16
image block at B=256, the text block at B=1024 (causal) and the ViT-L/14
image block at B=16.  Per shape: each of the block's four products with
its epilogue (qkv bias, out-proj bias + residual, fc bias + QuickGELU,
proj bias + residual) and the attention on the column slices of the fused
QKV buffer, as device ms (CUDA events around one call queued behind a
spinning kernel, median of ``--runs``), the builds timed in turns, forward
then backward (first, second, ..., second, first), and the mean of the
two passes reported beside each; the bound (the fp32 peak, 4-byte
values); one library call for the same function (``torch.addmm`` with the
epilogue; ``F.scaled_dot_product_attention`` on fp32 heads; TF32 off);
and each build's output against the first build's: equal bit for bit, or
its largest difference.  Prints the card's name and power limit, then one
JSON line.  Needs CUDA; raises without it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from protoclip_tpu_torch.ops import _build
from protoclip_tpu_torch.ops import kernels as K
from protoclip_tpu_torch.scripts._card import bound_ms, build, device_ms, k2_work

SHAPES = {  # name: (batch, L, D, heads, causal)
    "image": (256, 197, 768, 12, False),
    "text": (1024, 77, 512, 8, True),
    "vitl_image": (16, 257, 1024, 16, False),
}
GEMMS = {  # name: (K as a multiple of D, N as a multiple of D, epilogue)
    "qkv": (1, 3, "bias"),
    "out_proj": (1, 1, "bias_residual"),
    "fc": (1, 4, "bias_gelu"),
    "proj": (4, 1, "bias_residual"),
}


def in_turns(calls: dict, runs: int) -> dict:
    """{build: (mean ms, [forward ms, backward ms])}, the builds timed in
    order and then in reverse."""
    names = list(calls)
    times = {name: [] for name in names}
    for order in (names, names[::-1]):
        for name in order:
            times[name].append(device_ms(calls[name], runs, warmup=3))
    return {name: (sum(t) / len(t), t) for name, t in times.items()}


def bounds(tag: str) -> dict:
    """{product or "attention": (least ms, what bounds it)} at ``SHAPES[tag]``:
    ``k2_work``'s fp32 bytes and flops at the fp32 peaks."""
    b, l, d, _, causal = SHAPES[tag]
    work = k2_work(b, l, d, causal, "float32")
    entries = {**{name: f"gemm_bias_epilogue.{name}" for name in GEMMS},
               "attention": "attention_packed"}
    return {name: bound_ms(*work[entry], "float32")[:2] for name, entry in entries.items()}


def agreement(out: torch.Tensor, ref: torch.Tensor) -> dict:
    return {"bit_exact": bool(torch.equal(out, ref)),
            "max_abs_diff": float((out.double() - ref.double()).abs().max())}


def gemm_rows(libs, tag, runs, g) -> dict:
    b, l, d, _, _ = SHAPES[tag]
    m, dev, rows = b * l, torch.device("cuda"), {}
    for name, (kf, nf, epi) in GEMMS.items():
        k, n = kf * d, nf * d
        a = torch.randn(m, k, device=dev, generator=g)
        w = torch.randn(k, n, device=dev, generator=g) * k ** -0.5
        bias = torch.randn(n, device=dev, generator=g) * 0.02
        res = torch.randn(m, n, device=dev, generator=g) if "residual" in epi else None
        outs = {src: torch.empty(m, n, device=dev) for src in libs}

        def call(src):
            def run():
                _build.check(libs[src].gemm_bias_epilogue(
                    K._DTYPES[torch.float32], a.data_ptr(), w.data_ptr(), bias.data_ptr(),
                    None if res is None else res.data_ptr(), outs[src].data_ptr(), m, n, k,
                    K._EPILOGUES[epi], torch.cuda.current_stream().cuda_stream),
                    "gemm_bias_epilogue")
            return run

        def library():
            y = torch.addmm(bias, a, w)
            if epi == "bias_gelu":
                return y * torch.sigmoid(1.702 * y)
            return y if res is None else res + y

        timed = in_turns({src: call(src) for src in libs}, runs)
        first = next(iter(libs))
        bnd, by = bounds(tag)[name]
        rows[f"{tag}.{name}"] = {
            "M": m, "K": k, "N": n, "epilogue": epi, "bound_ms": bnd, "bound_by": by,
            "library_ms": device_ms(library, runs, warmup=3),
            "builds": {src: {"ms": ms, "passes_ms": t,
                             **agreement(outs[src], outs[first])}
                       for src, (ms, t) in timed.items()}}
        del a, w, bias, res, outs
        torch.cuda.empty_cache()
    return rows


def attention_row(libs, tag, runs, g) -> dict:
    b, l, d, h, causal = SHAPES[tag]
    dev, dh = torch.device("cuda"), d // h
    qkv = torch.randn(b, l, 3 * d, device=dev, generator=g)
    sl = (qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:])
    outs = {src: torch.empty(b, l, d, device=dev) for src in libs}

    def call(src):
        def run():
            _build.check(libs[src].attention_packed(
                K._DTYPES[torch.float32], *(t.data_ptr() for t in sl), l * 3 * d, dh, 3 * d,
                outs[src].data_ptr(), l * d, dh, d, b, l, h, dh, l, int(causal),
                K._ATTENTION_MODES["softmax"], dh ** -0.5,
                torch.cuda.current_stream().cuda_stream), "attention_packed")
        return run

    def heads(t):
        return t.reshape(b, l, h, dh).transpose(1, 2)

    timed = in_turns({src: call(src) for src in libs}, runs)
    first = next(iter(libs))
    bnd, by = bounds(tag)["attention"]
    plain = K.fused_attention_packed_plain(*sl, h, causal)
    row = {"B": b, "L": l, "D": d, "heads": h, "causal": causal, "bound_ms": bnd,
           "bound_by": by,
           "library_ms": device_ms(
               lambda: F.scaled_dot_product_attention(*map(heads, sl), is_causal=causal), runs,
               warmup=3),
           "builds": {src: {"ms": ms, "passes_ms": t, **agreement(outs[src], outs[first]),
                            "max_abs_err_vs_plain": float((outs[src] - plain).abs().max())}
                      for src, (ms, t) in timed.items()}}
    del qkv, sl, outs, plain
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gemm", type=Path, nargs="*", default=[],
                    help="more gemm_bias_epilogue.cu sources, after the package's")
    ap.add_argument("--attention", type=Path, nargs="*", default=[],
                    help="more attention_packed.cu sources, after the package's")
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("fp32_kernels needs an NVIDIA card (CUDA is not available)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    gemm_srcs = [_build.CSRC_DIR / "gemm_bias_epilogue.cu", *args.gemm]
    attn_srcs = [_build.CSRC_DIR / "attention_packed.cu", *args.attention]
    jobs = [(s, "gemm_bias_epilogue") for s in gemm_srcs] + [(s, "attention_packed")
                                                              for s in attn_srcs]
    with ThreadPoolExecutor(len(jobs)) as pool:  # one nvcc a source, all at once
        built = list(pool.map(lambda job: build(*job), jobs))
    gemm_libs = {str(s): lib for s, lib in zip(gemm_srcs, built)}
    attn_libs = {str(s): lib for s, lib in zip(attn_srcs, built[len(gemm_srcs):])}
    g = torch.Generator(device="cuda").manual_seed(0)
    result = {"nvidia_smi": smi, "runs": args.runs, "gemm_sources": list(gemm_libs),
              "attention_sources": list(attn_libs), "gemms": {}, "attention": {}}
    for tag in SHAPES:
        result["gemms"].update(gemm_rows(gemm_libs, tag, args.runs, g))
        result["attention"][tag] = attention_row(attn_libs, tag, args.runs, g)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
