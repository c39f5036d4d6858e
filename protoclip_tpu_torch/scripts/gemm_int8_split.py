"""Split the int8 GEMM's time on the card into main loop and epilogue.

    python -m protoclip_tpu_torch.scripts.gemm_int8_split [--source FILE.cu]

Compiles ``FILE.cu`` (default: the package's ``csrc/gemm_int8_epilogue.cu``)
twice with nvcc, as is and with ``-DGEMM_MAIN_LOOP_ONLY``, which stops
the kernel after its products, and times both builds with CUDA events at
the four GEMMs of a ViT-B/16 image block at B=256 (M = 256 x 197) and of a
text block at B=1024 (M = 1024 x 77, D = 512), each with its K3 epilogue
in bf16, plus fc with the fp32 epilogue that has no QuickGELU (the same
bytes: what the GELU's ``expf`` and IEEE division cost).  ``torch._int_mm``
on the same operands times a library main loop alone.  Prints the card's
name and power limit, then one JSON line: per GEMM the whole kernel, its
main loop, their difference (the epilogue), the bound of the epilogue's
bytes (fp32 or bf16 output written, bf16 residual read) and whether the
whole kernel's output equals its plain version bit for bit.  Needs CUDA;
raises without it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from protoclip_tpu_torch.ops import _build
from protoclip_tpu_torch.ops import kernels as K
from protoclip_tpu_torch.scripts._card import bound_ms, build, device_ms

RUNS = 20
SHAPES = {  # block: (M, D, {GEMM with K = D: (N, epilogue)}); proj (K = 4D) is added
    "image": (256 * 197, 768, {"qkv": (2304, "dequant_bias"),
                               "out_proj": (768, "dequant_bias_residual"),
                               "fc": (3072, "dequant_bias_gelu"),
                               "fc_nogelu": (3072, "dequant_bias_f32")}),
    "text": (1024 * 77, 512, {"qkv": (1536, "dequant_bias"),
                              "out_proj": (512, "dequant_bias_residual"),
                              "fc": (2048, "dequant_bias_gelu")}),
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=Path, default=_build.CSRC_DIR / "gemm_int8_epilogue.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("gemm_int8_split needs an NVIDIA card (CUDA is not available)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = {"whole": build(args.source, "gemm_int8_epilogue"),
            "main_loop": build(args.source, "gemm_int8_epilogue", "GEMM_MAIN_LOOP_ONLY")}
    g = torch.Generator(device="cuda").manual_seed(0)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    result = {"source": str(args.source), "nvidia_smi": smi, "gemms": {}}
    for tag, (m, d, gemms) in SHAPES.items():
        gemms = {**gemms, "proj": (d, "dequant_bias_residual")}
        for name, (n, epi) in gemms.items():
            k = 4 * d if name == "proj" else d
            a = torch.randint(-127, 128, (m, k), device=dev, dtype=torch.int8, generator=g)
            w = torch.randint(-127, 128, (n, k), device=dev, dtype=torch.int8, generator=g)
            a_s = torch.rand(m, 1, device=dev, generator=g) * 1e-2
            w_s = torch.rand(n, device=dev, generator=g) * 1e-2
            bias = torch.randn(n, device=dev, generator=g)
            res = torch.randn(m, n, device=dev, generator=g).to(bf16) if "residual" in epi else None
            out_bytes = 4 if epi in K._FP32_OUT_EPILOGUES else 2
            out = torch.empty(m, n, device=dev, dtype=torch.float32 if out_bytes == 4 else bf16)
            row = {"M": m, "K": k, "N": n, "epilogue": epi}
            for which, lib in libs.items():
                def run(lib=lib):
                    _build.check(lib.gemm_int8_epilogue(
                        K._DTYPES[bf16], a.data_ptr(), a_s.data_ptr(), w.data_ptr(),
                        w_s.data_ptr(), bias.data_ptr(), None if res is None else res.data_ptr(),
                        out.data_ptr(), m, n, k, K._INT8_EPILOGUES[epi],
                        torch.cuda.current_stream().cuda_stream), "gemm_int8_epilogue")
                row[f"{which}_ms"] = device_ms(run, RUNS, warmup=3)
            row["epilogue_ms"] = row["whole_ms"] - row["main_loop_ms"]
            run(libs["whole"])
            want = K.gemm_int8_epilogue_plain(a, a_s, w, w_s, bias, epi, bf16, res)
            torch.cuda.synchronize()
            row["bit_exact"] = bool(torch.equal(out, want))
            del want
            row["epilogue_bytes_bound_ms"] = bound_ms(
                m * n * (out_bytes + (2 if res is not None else 0)), 0)[0]
            row["int_mm_ms"] = device_ms(lambda: torch._int_mm(a, w.t()), RUNS, warmup=3)
            result["gemms"][f"{tag}.{name}"] = row
            del a, w, res, out
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
